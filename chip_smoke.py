"""End-to-end check of quandary_tpu_torch on one CUDA GPU.

Drives the port's main paths at the full width of the CNOT flagship
(bench.py:59-93: 2 transmons with 2 essential + 2 guard levels, N = 16,
4 basis states, ntime = 1221, split stepper with 3 iterations, Jtrace with
leakage, energy, dpdm and Tikhonov terms, complex64), through the entry
points a user calls: Quandary(...), python -m quandary_tpu_torch,
Problem(...).build_value_and_grad(),
optim.driver.run_optimization, optim.robust.build_packed_robust_objective,
optim.device_driver.run_optimization_device,
optim.batched_lbfgs.batched_lbfgsb, ops.stream.make_stream_propagate,
ops.dense.pallas_propagate_dense and calibration.KerrCalibration,
parallel.mesh (the 'init' and candidate axes on torch.distributed) and
profiling.trace, and systems past one thread block: closed up to N = 1024 on 'streamk', open
up to N = 128, on the streamed-plane routes, per-sample stacks and the
open superop route, and the structured engines past N = 1024 (the repo's
32^4 configuration, N = 2^20). Phases:

1. the device: CUDA must be available; prints the card's name and power
   limit as nvidia-smi gives them;
2. builds the kernels from the checkout, one nvcc per source and all
   seven at once: csrc/streamk.cu and csrc/streamk_mid.cu here,
   csrc/rho.cu reported in phase 11, csrc/stream.cu in phase 17,
   csrc/rho_mid_fwd.cu and csrc/rho_mid.cu in phase 26, csrc/stream_mid.cu
   in phase 27; starts the worker of CPU references (phase 14's f64 runs
   first, then phase 26's);
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
   host's time: phase 16 holds the kernels against plain at full depth;
   the worker computes these references while the card runs phases 2-13);
15. a few L-BFGS-B iterations on configuration 2 through
   run_optimization_device (J falls; the CUDA graph's launches counted);
16. times: rho_fwd / rho_bwd at N = 16 (E = 1, 8), 27, 64, with each
   kernel's cluster (CTAs per density matrix, CTAs launched, tile, threads)
   and time per step, sweeps/s of the
   three configurations, the plain version's times, the bounds; the history
   and cotangents of the timed kernels against those of the timed plain
   runs, at configuration 2's full depth and configuration 3's first
   PLAIN16_NT = 250 steps (cut for the run's time).

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
19. fused_mode='chunk' at dt/4 cut to a quarter of the horizon (1221 steps,
   T = 50 ns, for the run's time; phase 21 times the kernels at 4884)
   against plain on the card and a new f64 reference;
   pallas_propagate_dense's xT against the chunk forward's and plain;
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

The front end, the entry points users call (quandary_tpu_torch.Quandary
and the config-file CLI), on the card:
22. Quandary(precision="single") on the CNOT anchor of
   scripts/perf/device_opt_bench.py:41-47 (derived nsteps 1221, rand_seed
   1234 through the native library, which must have built): simulate (one
   streamk_fwd launch; infidelity, expected energy and population against
   precision="double" on the CPU), then the device driver to infidelity
   1e-4 (one streamk_fwd and one streamk_bwd launch per sweep, J falls, the
   output files read back by get_results); iterations, infidelity, wall;
23. the guarded CNOT of tests/test_api.py:195-214 with T1 = 56, T2 = 28 ns
   at precision="single", its horizon cut from 140 to OPEN_FE_T = 35 ns
   (about 2350 steps): the rho route (its clusters printed), simulate
   (one rho_fwd launch, every population summing to 1) and a few device
   iterations (one launch per direction per sweep);
24. `python -m quandary_tpu_torch` (run in-process as `-m` runs it) on
   config_template.cfg for simulation, gradient and optimization
   (optim_maxiter lowered): complex128, so off the kernels, on the
   time-parallel scan that 'auto' takes there (as the reference does), no
   kernel launched; grad.dat, optim_history.dat and the population files
   against cli.run(device="cpu"); each runtype's wall.

Closed systems past one thread block, on the mid-size streamK pair
(csrc/streamk_mid.cu: a thread-block cluster per candidate and chunk of
basis states):
25. the flagship stays on the one-block pair; both mid kernels against the
   plain version on the card at MID_NT_CUT = 64 steps (the plain version
   materializes (ntime, N, N) planes), with stored and replayed stage
   iterates: three qubits with two guard levels (N = 64, 8 basis states,
   split-3) at E = 1 and 4, and scripts/perf/midsize_bench.py's closed
   systems (N = 256 pure and basis, 512 and 1024 pure; split-4), over
   every layout and backward schedule the planner picks (the bands of H in
   shared memory or in device-memory scratch; the column pass on helper
   clusters, 'helpers', or in the chain, 'chain'); two launches give the
   same bits; at N = 256 and 1024 pure the two schedules give g0 in the
   same bits and C-bar within TOL_GRAD_REL, and g0 and C-bar are the same
   bits from stored and from replayed iterates (stored_replayed); then Problem
   (fused=True and 'auto') on the four midsize systems at their full 1000
   steps, one launch of each mid kernel per sweep: sweeps/s, kernel ms,
   bounds, the clusters (G CTAs, Bc states); then
   Quandary(precision="single") on the SWAP02 of tests/test_api.py:95-125
   with Ng = [2, 2, 2] (N = 64, T = 8 ns): simulate against
   precision="double" on the CPU (TOL_MID_FE_*), optimize 10 device
   iterations (the cost falls; 1 + 1 mid launches per sweep).

Open systems past N = 64, on the mid-size density-matrix pair
(csrc/rho_mid_fwd.cu, csrc/rho_mid.cu: a thread-block cluster per density
matrix, the operand whole in every CTA, M(t) in device-memory scratch; the
forward's band factors in shared memory, its whole factors read from L2
16 bytes a lane, its operand exchanged by bulk copies):
26. rho_mid_fwd / rho_mid_bwd against the plain version on the card at
   NT_SHORT steps, at N = 65, 96, 125 and 128 (rho_bench-style open
   systems: two qudits [5, 13], [8, 12], [8, 16] and three 5-level
   qudits), neumann, jacobi and split, with and without jump operators,
   stored and replayed iterates, two cluster sizes, the replaying
   backward on both of its schedules ('split': the replay on clusters of
   its own ahead of the adjoint, 'chain': in the adjoint's chain); the
   same bits across G (8 against 16), between stored and replayed
   iterates on both schedules and on a repeat; 'split' at E B = 24 on
   clusters of 16 (more than the card holds at once) against plain and
   'chain'; qudits125 (rho_bench's 3 qutrits with two guard levels each,
   N = 125, 1000 steps, jacobi-6) through Problem (fused=True and 'auto')
   at full depth: 1 + 1 mid launches per sweep, J and gradient against
   plain on the card at NT_SHORT steps and the f64 port on the CPU at
   NT_F64 steps (computed by a worker process on the host while the
   card runs phases 2-25), sweeps/s, kernel ms, bounds, clusters, the
   plain version's times at full depth; qudits128 (two qudits [8, 16],
   the edge of the range) kernel ms and bound; Quandary(precision=
   "single") on qudits125's physics (Ne = [3, 3, 3], Ng = [2, 2, 2], T1,
   T2, '3states', T = RHO_MID_FE_T): the rho route, simulate against
   precision="double" on the CPU (the worker's), 2 device iterations.

The streamed-plane kernels past one thread block (csrc/stream_mid.cu: a
thread-block cluster per candidate and chunk of basis states, each CTA on
a band of the state entries reading its bands of the planes):
27. stream_mid_fwd / stream_mid_bwd, chunk_mid_fwd / chunk_mid_bwd and
   dense_mid_fwd against the plain version on the card at SMID_NT = 64
   steps on random non-Hermitian stacks of norm about 1 (N = 200 with
   B = 4, 256 with B = 1, 16 and 256, 512 with B = 1; 'chunk' and dense
   also N = 1024), neumann, jacobi and split, stored and replayed
   iterates, E = 1 and 2, every layout of the bands (two slots, one slot,
   global), the backward's chunks of states on fewer tracks than chunks
   (N = 256 basis; 4 chunks on 1, 2 and 4 tracks); the same bits on a
   repeat and between stored and replayed iterates;
   Problem(fused_mode='stream') (fused=True and 'auto') on midsize_bench's
   N = 256 and 512 pure at 1000 steps: 1 + 1 mid launches per sweep, J and
   gradient against the mid streamK route at full depth and plain at 64
   steps, sweeps/s, kernel ms, bounds, the shapes; the guarded open CNOT
   on 'stream' (superop, dim 256, 16 basis matrices, 1221 steps) against
   phase 14's rho route and f64 reference; fused_mode='chunk' on N = 256 at
   CHUNK_MID_T (1000 steps where plain Neumann converges) against plain on
   the card; pallas_propagate_dense past one block; the forward in every
   band layout and band-row count that fits (SMID_FWD_LAYOUT_CASES) in the
   bits of the planner's launch; 'chunk' at N = 1024 (300 steps) timed
   and against plain.

Per-sample stacks and the open superop route past one thread block (the
mid streamK pair reading each candidate's stack and solver rows at a
stride), and the packed robust objective of open systems:
28. the mid pair on per-block plans against the plain version on the card
   at PB_NT = 64 steps on random non-Hermitian stacks (N = 64 and 200, S =
   2 and 3 samples, B = 1 to 8 states), neumann, jacobi and split, stored
   and replayed iterates: the same bits on a repeat and between stored
   and replayed iterates; open configuration 2 (N = 16, 16 basis
   matrices, 1221 steps) forced to superop on 'streamk', dim 256 on the
   mid pair, against the rho route (phase 14) and superop on 'stream',
   and rho_bench's N = 27 (dim 729, 1000 steps) against the rho route,
   each route's kernels timed interleaved; the packed robust gradient of
   open configuration 1 with S_OPEN_ROBUST = 8 detuned realizations (S *
   dim = 128, the reference's edge) on one block, of three open qubits
   (N = 8, 64 basis matrices, 2 realizations) and of the closed SWAP02
   (N = 64, 2 realizations) on the mid pair: exactly 1 + 1 packed
   launches per gradient, J and gradient against build_robust_objective,
   walls and kernel times.

The large-N structured engines (ops/tensor_rhs.py, ops/grouped_rhs.py,
ops/grouped_lindblad.py, with ops/grouped_adjoint.py and ops/reversible.py):
products the reference computes outside any Pallas kernel, so they launch
no kernel of csrc/ (each path below is driven with the counters at 0 and
fails if any kernel launched); float32 products must be full f32:
29. (a) `python -m quandary_tpu_torch` on scripts/perf/nlevels_32_32_32_32.cfg
   (four 32-level transmons, N = 2^20, complex128, 50 steps) as it stands
   and with runtype gradient: GroupedEngine, the guard's 'split', the
   grouped adjoint, walls; the forward sweep of
   scripts/perf/large_n_bench.py (complex64, the real-plane step on the
   ground and a high corner state): wall, ms a step, norm drifts, the
   bound of the forward at 67 TFLOP/s; (b) Problem(...).build_value_and_grad()
   on that setup in complex64 (the hand-written grouped adjoint), median
   wall of 3 and the bounds, J and gradient against complex128 on the
   card ((a)'s gradient run), against 'reversible-ad' at full depth and
   against 'remat' at
   LARGE_REMAT_NT steps; (c) engine='tensor' against 'grouped' at 32^4,
   forward xT; (d) scripts/perf/lindblad_large_n.py's open N = 1024 (rho of
   2^20 entries, 50 steps) on GroupedLindbladEngine: trace, J and gradient
   against complex128 on the card, the forward against engine='tensor';
   (e) Quandary(precision="single") at nlevels 6,6,6,6 (N = 1296, the
   tensor engine, the reversible adjoint): J and gradient against the
   port's f64 on the CPU (the worker's, after phase 26's).

The time-parallel scan (ops/propagator.py: step matrices and prefix
products by batched torch.matmul, as the reference's XLA products; no
kernel of csrc/ in (a)-(d)), the host-loop runner (ops/hostloop.py) and
the Hessian tools (optim/hessian.py):
30. (a) config_template.cfg's Problem on the card (complex128), which
   'auto' sends to the scan, against time_parallel=False: J, every aux
   term, gradient and trajectory within tests/test_time_parallel.py's
   bounds, the median wall of 3 gradients each, one chunk of 2 device
   iterations with graph=True on the scan; (b) that test's open case (N =
   6, dim 36) forced, against the sequential loop; (c) SWAP02's physics
   (N = 64, B = 8, jacobi-3, complex128): against the sequential loop at
   TP_CUT_NT steps, the forward at the budget's edge (TP_EDGE_NT steps,
   2^27 entries, 2 GiB a (T, N, N) array) with every state's norm, the
   gradient at TP_GRAD_NT steps, walls and peak device memory, the
   complex64 scan's gradient against complex128 (a TF32 product breaks
   it); (d) HostLoopRunner forward and gradient on tests/test_hostloop.py's
   problem against the plain route; (e) hessian against fd_hessian on
   tests/test_hessian_sanity.py's problem in f64 (the scan), hessian
   refused by name on the streamK route, and fd_hessian through it in
   complex64 (eps TP_FD_EPS32; 2 nparams launches of each kernel) against
   the f64 AD Hessian.

Multi-device on torch.distributed (parallel/multihost.py, parallel/mesh.py)
and the profiler (profiling.py); the machine holds one card:
31. (a) a one-rank NCCL mesh (make_mesh(1, 1)): the flagship's 'init' axis
   (shard_problem), its ensemble at E = 128 (mesh=) and two sweeps, each a
   main path of its own, must be the unsharded runs' bits at 1 + 1 launches
   a sweep; (b) two ranks sharing the card over gloo (processes of their
   own, `python3 chip_smoke.py --mesh-rank RANK PORT FILE`, loading the
   kernels phase 2 built): the flagship's 'init' axis (B = 4, 2 a rank),
   the ensemble at MESH_E = 16, its sweeps and 6 iterations of the
   population optimizer on make_mesh(2, 1), the two ranks the same bits and
   within TOL_MESH_* of one process; (c) profiling.trace around one warm
   flagship sweep at E = 1: one streamk_fwd and one streamk_bwd in the
   trace, the card's busy and idle share of the sweep's window, and
   profiling.sweep_timer's rate beside phase 6's.

Each main path (4-5, 8, 9, 10, 13, 14, 15, 18, 19, 20, 22, 23, 24, 25, 26,
27, 28, 29, 30, 31) is driven with the launch counters set to 0 just before and read
just after. Before the device record one line lists the twenty-two kernels
with their launches, error, time, plain time and bound.
Any failure raises (non-zero exit). The last line is the device record:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Run from the repository root:  python3 chip_smoke.py
(`python3 chip_smoke.py --cpu-references FILE` is the worker phase 2
starts; it computes on the CPU only. `python3 chip_smoke.py --mesh-rank
RANK PORT FILE` is one of phase 31's two ranks.)
"""

import contextlib
import dataclasses
import functools
import json
import math
import os
import re
import runpy
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch
import torch.distributed as dist

from quandary_tpu_torch import Quandary, cli, profiling
from quandary_tpu_torch.io import native
from quandary_tpu_torch.io.configfile import Config, setup_from_config
from quandary_tpu_torch.models import gates
from quandary_tpu_torch.models.hamiltonian import build_standard_model
from quandary_tpu_torch import calibration
from quandary_tpu_torch.ops import (cuda_build, dense, rho, rho_mid, stream,
                                    stream_mid, streamk, streamk_mid)
from quandary_tpu_torch.ops.hostloop import HostLoopRunner
from quandary_tpu_torch.ops.grouped_rhs import (make_real_imr_step,
                                                make_real_split_step)
from quandary_tpu_torch.ops.tensor_rhs import build_structured_model
from quandary_tpu_torch.optim import robust
from quandary_tpu_torch.optim.batched_lbfgs import batched_lbfgsb
from quandary_tpu_torch.optim.device_driver import run_optimization_device
from quandary_tpu_torch.optim.driver import build_bounds, run_optimization
from quandary_tpu_torch.optim.hessian import (fd_hessian, hessian,
                                              hessian_eigen)
from quandary_tpu_torch.parallel import mesh, multihost
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
# phase 27's random states are not normalised (entries up to about 4.5):
# xT and hist x max|plain|, the mid streamK pair's 1e-5 taken relative;
# measured 2.8e-6 at B <= 16 and 5.1e-6 at N = 256 with 256 states, whose
# max runs over 16x more entries (PERF.md, slice 16)
TOL_STATE_REL = 1e-5
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
# The front end (phases 22-24), bounds about 5x the errors measured on an
# H100 80GB HBM3 (700 W). Phase 22: Quandary(precision="single") on the card
# (objective on the streamK kernels, trajectory by the plain f32 loop)
# against precision="double" on the CPU: infidelity abs (measured 3.1e-8),
# expected energy and population abs over the trajectory (2.2e-6). Phase
# 23: each population of the open guarded CNOT (f32 plain loop, 9418 steps
# before the depth was cut to OPEN_FE_T) sums to 1 (4.9e-6). Phase 24: the
# CLI in f64 on the card against the CLI on the CPU, relative to each
# file's largest entry (4.0e-15).
TOL_FE_INFID = 2e-7
TOL_FE_TRAJ = 1e-5
TOL_FE_TRACE = 2.5e-5
TOL_CLI_REL = 2e-14
# Phase 25 holds the mid-size streamK pair to TOL_STATE_ABS and
# TOL_GRAD_REL (measured on an H100 80GB HBM3, 700 W, at 64 steps: states
# 1.1e-6 abs, cotangents 6.1e-6 x max, both at N = 256 with 256 basis
# states). Its front end, SWAP02 with two guard levels per qubit (N = 64,
# 2489 steps of 20 Neumann iterations; phase 22's CNOT: N = 4, 1221 steps)
# against precision="double" on the CPU, has its own bounds, about 5x the
# errors measured: infidelity 5.9e-8, expected energy and population
# 5.2e-6 abs.
TOL_MID_FE_INFID = 3e-7
TOL_MID_FE_TRAJ = 2.5e-5
NT_SHORT = 40           # steps of the comparisons with the plain version
NT_F64 = 400            # steps of configurations 2 and 3 against f64
PLAIN16_NT = 250        # steps of configuration 3's plain runs in phase 16
E_OPEN = 8


def flagship_setup(linsolver="split", linsolve_iters=3, dtype=torch.complex64,
                   freq01=FREQ01, ntime=1221, fused_mode="streamk",
                   fused=True, T=200.0):
    """bench.py:59-93, built with the port's own functions. `freq01` detunes
    the qubits against the rotating frame and the carriers, which stay at
    the nominal frequencies (a system realization of the robust ensemble).
    `ntime` refines the time step at the horizon T (ns, the bench's 200 by
    default)."""
    Ne, Ng = [2, 2], [2, 2]
    nlevels = [e + g for e, g in zip(Ne, Ng)]
    model = build_standard_model(
        nlevels=nlevels, freq01_ghz=freq01, rotfreq_ghz=FREQ01,
        selfkerr_ghz=SELFKERR, jkl_ghz=[0.005], crosskerr_ghz=[])
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
        fused_mode=fused_mode, fused=fused)


def bench_params(n, E=None, seed=1234):
    """The bench's parameter draw: uniform(-1, 1) * 0.005."""
    shape = (n,) if E is None else (E, n)
    return np.random.default_rng(seed).uniform(-1, 1, shape) * 0.005


def open_cnot_setup(guards, dtype=torch.complex64, ntime=1221,
                    fused_rho="auto", fused=True, freq01=FREQ01):
    """scripts/perf/lindblad_pallas_bench.py:29-63, built with the port's
    own functions: the CNOT with T1/T2 collapse, without guard levels
    (N = 4) or with two per qubit (N = 16), 16 basis density matrices.
    `ntime` below 1221 cuts the horizon at the same step. `freq01` detunes
    the qubits as flagship_setup's does (a robust ensemble's realization)."""
    Ne, Ng = [2, 2], ([2, 2] if guards else [0, 0])
    nlevels = [e + g for e, g in zip(Ne, Ng)]
    model = build_standard_model(
        nlevels=nlevels, freq01_ghz=freq01, rotfreq_ghz=FREQ01,
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
        fused_rho=fused_rho, fused=fused)


# scripts/perf/rho_bench.py:25-65's open systems by N: 3 qutrits (N = 27)
# and two 8-level qudits (N = 64); past one CTA of csrc/rho.cu, qudits125
# (the 3 qutrits with two guard levels each, N = 125) and qudits128 (the two
# qudits with 16 levels on the second, N = 128, the edge of the TPU kernel's
# range); N = 65 and 96 only hold the mid kernels against plain (phase 26)
QUTRITS = dict(freq01=[4.80595, 4.8601, 4.9], selfkerr=[0.2198, 0.2252, 0.22],
               jkl=[0.005, 0.0, 0.004], decay=[80.0, 90.0, 85.0],
               dephase=[40.0, 45.0, 42.0])
QUDITS = dict(freq01=[4.80595, 4.8601], selfkerr=[0.2198, 0.2252],
              jkl=[0.005], decay=[80.0, 90.0], dephase=[40.0, 45.0])
MIDSIZE_OPEN = {27: dict(QUTRITS, nlevels=[3, 3, 3]),
                64: dict(QUDITS, nlevels=[8, 8]),
                65: dict(QUDITS, nlevels=[5, 13]),
                96: dict(QUDITS, nlevels=[8, 12]),
                125: dict(QUTRITS, nlevels=[5, 5, 5]),
                128: dict(QUDITS, nlevels=[8, 16])}


def midsize_setup(N, dtype=torch.complex64, ntime=1000, fused=True):
    """scripts/perf/rho_bench.py:25-65 (MIDSIZE_OPEN[N]) with T1/T2 collapse
    on every oscillator, '3states' initial conditions, a random pure target
    state (seed 42), 6 stage iterations, 20 splines per oscillator.
    `ntime` below 1000 cuts the horizon at the same step."""
    cfg = MIDSIZE_OPEN[N]
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
        linsolve_iters=6, fused=fused)


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


def kernel_ms(plan, x0r, x0i, C, reps, plain_reps, plain_warm=True):
    """CUDA-event times of both kernels (the pair the dispatch picks: one
    block, or the mid pair past it) and of their plain versions for one
    plan (plain_warm False: without a warm-up run, as phases 25-28 time
    their seconds-long plain sweeps), and the launch's bounds."""
    kfwd, kbwd = streamk._pair(streamk.uses_mid(plan, *x0r.shape))
    fwd = kfwd(plan, x0r, x0i, C)
    hr, hi, ksr, ksi = fwd[2:]
    ones_T, ones_h = torch.ones_like(fwd[0]), torch.ones_like(hr)
    out = dict(
        fwd=event_ms(lambda: kfwd(plan, x0r, x0i, C), reps),
        bwd=event_ms(lambda: kbwd(
            plan, x0r, x0i, C, hr, hi, ksr, ksi, ones_T, ones_T, ones_h,
            ones_h), reps))
    if plain_reps:
        out.update(
            plain_fwd=event_ms(
                lambda: streamk.plain_forward(plan, x0r, x0i, C), plain_reps,
                plain_warm),
            plain_bwd=event_ms(lambda: streamk.plain_backward(
                plan, x0r, x0i, C, hr, hi, ones_T, ones_T, ones_h, ones_h),
                plain_reps, plain_warm))
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
                state_rel=max_rel(sk, sp),
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
    (`full_depth`: states abs, cotangents x max); `plain` an int: the plain
    run and that comparison at the first `plain` steps only (`plain_steps`:
    the depth they ran at)."""
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
    # (the mid pair's, past csrc/rho.cu, as its wrapper logged it)
    mid = rho.uses_mid(plan.N, plan.K, plan.njump, E, B)
    lib = None if mid else cuda_build.library(rho._SRC, rho._bind)
    for key, args in (("fwd", rho._fwd_args), ("bwd", rho._bwd_args)):
        if mid:
            m = rho_mid.mid_layouts[key]
            tile, G, threads, ctas = m["tile"], m["G"], m["threads"], \
                m["ctas"]
        else:
            tile, G, threads, _ = args(lib, plan, E, nt, B, store)[-4:]
            ctas = E * B * G
        out[f"{key}_cluster"] = dict(G=G, ctas=ctas, tile=tile,
                                     threads=threads)
        if mid and key == "bwd":
            out["bwd_cluster"].update(schedule=m["schedule"], ring=m["ring"])
        out[f"{key}_us_per_step"] = 1e3 * out[key] / nt
    if plain is not True and plain:
        # the comparison at a cut depth: the kernels again on its rows
        C = C[:, :plain]
        out["plain_steps"] = C.shape[1]
        fwd = rho._kernel_fwd(plan, x0r, x0i, C)
        hr, hi, ksr, ksi = fwd[2:]
        oT, oh = torch.ones_like(fwd[0]), torch.ones_like(hr)
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


def robust_vg(objective, params, device):
    """(J, gradient, aux) of a robust objective at one control vector."""
    xt = torch.as_tensor(params, device=device).requires_grad_(True)
    Jr, auxr = objective(xt, torch.zeros_like(xt))
    (gr,) = torch.autograd.grad(Jr, xt)
    return Jr.detach(), gr, auxr


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


OPEN14 = ("cnot16", "qutrits27", "qudits64")   # phase 14's configurations
OPEN_CONFIGS = {
    "cnot4": lambda **kw: open_cnot_setup(False, **kw),
    "cnot16": lambda **kw: open_cnot_setup(True, **kw),
    "qutrits27": lambda **kw: midsize_setup(27, **kw),
    "qudits64": lambda **kw: midsize_setup(64, **kw),
    "qudits125": lambda **kw: midsize_setup(125, **kw),
    "qudits128": lambda **kw: midsize_setup(128, **kw),
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
    streamk_mid.reset_launch_counts()
    rho.reset_launch_counts()
    rho_mid.reset_launch_counts()
    stream.reset_launch_counts()
    stream_mid.reset_launch_counts()


def main_path_launches(names):
    """Reads the counters after a main path was driven (they were set to 0
    just before it) and fails if a kernel of that path never launched."""
    counts = {**streamk.launch_counts(), **streamk_mid.launch_counts(),
              **rho.launch_counts(), **rho_mid.launch_counts(),
              **stream.launch_counts(), **stream_mid.launch_counts()}
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


CNOT4 = np.eye(4)
CNOT4[2:, 2:] = [[0, 1], [1, 0]]
OPEN_FE_ITERS = 4       # device iterations of phase 23
# phase 23's horizon, ns: tests/test_api.py:195-214 runs 140 ns (9418 plain
# steps of the trajectory, 91 s of the run); cut to a quarter of its depth
OPEN_FE_T = 35.0
CLI_MAXITER = 2         # optim_maxiter of phase 24's optimization run


def front_end_errors(got, ref):
    """Phase 22: the 6-tuple of simulate against another one: infidelity,
    expected energy and population, absolute."""
    energy = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                 for ea, eb in zip(got[4], ref[4]) for a, b in zip(ea, eb))
    pop = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
              for pa, pb in zip(got[5], ref[5]) for a, b in zip(pa, pb))
    return dict(infidelity=abs(got[3] - ref[3]), energy=energy,
                population=pop)


def file_errors(dir_a, dir_b, names):
    """Largest |a - b| over max |b| of each numeric output file."""
    out = {}
    for name in names:
        a = np.loadtxt(os.path.join(dir_a, name))
        b = np.loadtxt(os.path.join(dir_b, name))
        if a.shape != b.shape:
            raise RuntimeError(f"{name}: shape {a.shape} against {b.shape}")
        out[name] = float(np.abs(a - b).max()) / max(float(np.abs(b).max()),
                                                     1e-300)
    return out


def device_sweeps(niter, chunk=10):
    """Gradient sweeps of run_optimization_device on a fused route: the
    initial one, an eager warm-up chunk before the capture, and every
    replayed chunk (all of a chunk's iterations run, done or not)."""
    return 1 + chunk * (1 + math.ceil(niter / chunk))


def front_end(smi):
    """Phases 22-24: Quandary and the config-file CLI on the card."""
    out = {}
    if native.get_lib() is None:
        raise RuntimeError("the native IO/RNG library "
                           "(csrc/quandary_native.cpp) did not build: "
                           "rand_seed would not give the reference's "
                           "initial controls")
    favg = sum(FREQ01) / 2
    kw = dict(freq01=FREQ01, Jkl=[0.005], rotfreq=[favg, favg], T=200.0,
              targetgate=CNOT4, rand_seed=1234)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        # ---- 22. single precision, closed: the streamK kernels ----
        q32 = Quandary(precision="single", optimizer="device", maxiter=200,
                       tol_infidelity=1e-4, **kw)
        q64 = Quandary(precision="double", device="cpu", **kw)
        s32 = q32._build_setup()
        p0 = q32._initial_params(s32.oscillators)
        if q32.nsteps != 1221 or not np.array_equal(
                p0, q64._initial_params(s32.oscillators)):
            raise RuntimeError(f"derived nsteps {q32.nsteps} (want 1221) "
                               "or seeded controls differ")
        form = q32._problem(s32).fused_form
        if form != "streamk":
            raise RuntimeError(f"single-precision CNOT took route {form}")
        reset_counts()
        t0 = time.perf_counter()
        r32 = q32.simulate(pcof0=p0, datadir=os.path.join(tmp, "sim32"))
        torch.cuda.synchronize()
        t_sim = time.perf_counter() - t0
        sim_launches = main_path_launches(B1[:1])
        if sim_launches[B1[0]] != 1 or sim_launches[B1[1]] != 0:
            raise RuntimeError(f"simulate: one streamk_fwd launch expected: "
                               f"{sim_launches}")
        r64 = q64.simulate(pcof0=p0, datadir=os.path.join(tmp, "sim64"))
        errs = front_end_errors(r32, r64)
        if errs["infidelity"] > TOL_FE_INFID or errs["energy"] > TOL_FE_TRAJ \
                or errs["population"] > TOL_FE_TRAJ:
            raise RuntimeError(f"single-precision simulate against f64 CPU "
                               f"out of bounds: {errs}")
        dopt = os.path.join(tmp, "opt32")
        reset_counts()
        t0 = time.perf_counter()
        ro = q32.optimize(pcof0=p0, datadir=dopt)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = main_path_launches(B1)
        niter = len(q32.optim_hist["Iters"]) - 1
        want = device_sweeps(niter)
        if launches[B1[0]] != want or launches[B1[1]] != want:
            raise RuntimeError(f"optimize: {want} sweeps of one streamk_fwd "
                               f"and one streamk_bwd launch each expected "
                               f"after {niter} iterations: {launches}")
        J = np.loadtxt(os.path.join(dopt, "optim_history.dat"))[:, 1]
        names = (["params.dat", "optim_history.dat", "control0.dat",
                  "control1.dat"]
                 + [f"{k}{i}.iinit{b:04d}.dat" for k in ("expected",
                                                         "population")
                    for i in range(2) for b in range(4)])
        missing = [n for n in names
                   if not os.path.exists(os.path.join(dopt, n))]
        res = q32.get_results(datadir=dopt)
        if missing or not J[-1] < J[0] or not np.allclose(
                res[6], q32.popt, rtol=1e-13, atol=0) \
                or abs(res[7] - ro[3]) > 1e-12 \
                or len(res[0]) != q32.nsteps + 1 \
                or [len(e) for e in res[4]] != [4, 4] \
                or [len(pp) for pp in res[5]] != [4, 4]:
            raise RuntimeError(f"optimize: files missing {missing}, J "
                               f"{J[0]} -> {J[-1]}, or get_results differs")
        out["cnot"] = dict(simulate=sim_launches, optimize=launches)
        phase(22, f"Quandary(precision='single') CNOT, nsteps {q32.nsteps}, "
                  f"native library loaded, route {form}: simulate "
                  f"{t_sim:.2f} s, against precision='double' on the CPU "
                  f"{json.dumps(errs)}; optimize (device driver, CUDA "
                  f"graph): {niter} iterations, infidelity {ro[3]:.6e}, J "
                  f"{J[0]:.8f} -> {J[-1]:.8f}, wall {wall:.2f} s, launches "
                  f"{json.dumps(launches)} ({want} sweeps); files read back "
                  f"by get_results; card: {smi}")

        # ---- 23. single precision, open: the rho kernels ----
        qo = Quandary(Ne=[2, 2], Ng=[1, 1], freq01=FREQ01,
                      rotfreq=[favg, favg], selfkerr=SELFKERR, Jkl=[0.005],
                      T=OPEN_FE_T, targetgate=CNOT4, rand_seed=1234,
                      gamma_leakage=0.1, T1=[56.0, 56.0], T2=[28.0, 28.0],
                      precision="single", optimizer="device",
                      maxiter=OPEN_FE_ITERS)
        so = qo._build_setup()
        po = qo._problem(so)
        if po.fused_form != "rho":
            raise RuntimeError(f"open guarded CNOT took route {po.fused_form}")
        nj = len(po.engine.Ls_np)
        clusters = {k: dict(zip(("G", "tile", "threads"), fn(
            1, po.ninit, po.N, po.model.K, nj)[:3]))
            for k, fn in (("rho_fwd", rho._fwd_shape),
                          ("rho_bwd", rho._bwd_shape))}
        p0o = qo._initial_params(so.oscillators)
        reset_counts()
        t0 = time.perf_counter()
        rs = qo.simulate(pcof0=p0o, datadir=os.path.join(tmp, "open_sim"))
        torch.cuda.synchronize()
        t_osim = time.perf_counter() - t0
        osim = main_path_launches(B4[:1])
        trace = max(float(np.abs(np.asarray(pp).sum(axis=0) - 1.0).max())
                    for per in rs[5] for pp in per)
        if osim[B4[0]] != 1 or osim[B4[1]] != 0 or trace > TOL_FE_TRACE:
            raise RuntimeError(f"open simulate: launches {osim}, trace "
                               f"error {trace}")
        reset_counts()
        t0 = time.perf_counter()
        roo = qo.optimize(pcof0=p0o, datadir=os.path.join(tmp, "open_opt"))
        torch.cuda.synchronize()
        owall = time.perf_counter() - t0
        olaunch = main_path_launches(B4)
        oniter = len(qo.optim_hist["Iters"]) - 1
        owant = device_sweeps(oniter)
        ocost = qo.optim_hist["Cost"]
        trace_opt = max(float(np.abs(np.asarray(pp).sum(axis=0) - 1.0).max())
                        for per in roo[5] for pp in per)
        if olaunch[B4[0]] != owant or olaunch[B4[1]] != owant \
                or not ocost[-1] < ocost[0] or trace_opt > TOL_FE_TRACE:
            raise RuntimeError(f"open optimize: {owant} sweeps expected, "
                               f"launches {olaunch}; cost {ocost}; trace "
                               f"error {trace_opt}")
        out["open"] = dict(simulate=osim, optimize=olaunch)
        phase(23, f"Quandary(precision='single') open guarded CNOT (N = "
                  f"{po.N}, {po.ninit} density matrices, nsteps {qo.nsteps}, "
                  f"{nj} jump operators): fused_form {po.fused_form}, "
                  f"clusters {json.dumps(clusters)}; simulate {t_osim:.2f} "
                  f"s, launches {json.dumps(osim)}, trace error {trace:.3e}; "
                  f"optimize {oniter} device iterations in {owall:.2f} s, "
                  f"cost {ocost[0]:.6f} -> {ocost[-1]:.6f}, launches "
                  f"{json.dumps(olaunch)} ({owant} sweeps), trace error "
                  f"{trace_opt:.3e}; card: {smi}")

        # ---- 24. the CLI on the card: config_template.cfg, complex128 ----
        with open("config_template.cfg") as f:
            template = f.read()
        walls, errs, forms = {}, {}, {}
        for rt in ("simulation", "gradient", "optimization"):
            body = re.sub(r"^runtype\s*=\s*\w+", f"runtype = {rt}",
                          template, flags=re.M)
            if rt == "optimization":
                body = re.sub(r"^optim_maxiter\s*=\s*\d+",
                              f"optim_maxiter = {CLI_MAXITER}", body,
                              flags=re.M)
            cfgs = {}
            for where in ("card", "cpu"):
                d = os.path.join(tmp, f"cli_{rt}_{where}")
                os.makedirs(d)
                cfgs[where] = os.path.join(d, "config.cfg")
                with open(cfgs[where], "w") as f:
                    f.write(body)
            setup_c, spec = setup_from_config(Config.read(cfgs["card"]),
                                              os.path.dirname(cfgs["card"]))
            pr = Problem(setup_c)
            forms[rt] = pr.fused_form
            if not pr.time_parallel:
                raise RuntimeError(f"CLI {rt}: 'auto' did not take the "
                                   "time-parallel scan")
            reset_counts()
            argv = sys.argv
            sys.argv = ["quandary_tpu_torch", cfgs["card"], "--quiet"]
            t0 = time.perf_counter()
            try:    # what `python -m quandary_tpu_torch config.cfg` runs
                runpy.run_module("quandary_tpu_torch", run_name="__main__",
                                 alter_sys=True)
                code = 0
            except SystemExit as e:
                code = e.code
            finally:
                sys.argv = argv
            torch.cuda.synchronize()
            walls[rt] = time.perf_counter() - t0
            counts = {**streamk.launch_counts(), **rho.launch_counts(),
                      **stream.launch_counts(),
                      **streamk_mid.launch_counts()}
            if code != 0 or forms[rt] is not None or any(counts.values()):
                raise RuntimeError(f"CLI {rt}: exit {code}, fused_form "
                                   f"{forms[rt]}, launches {counts}")
            t0 = time.perf_counter()
            cli.run(cfgs["cpu"], device="cpu")
            walls[f"{rt}_cpu"] = time.perf_counter() - t0
            dc, dh = (os.path.join(os.path.dirname(cfgs[w]), spec.datadir)
                      for w in ("card", "cpu"))
            names = ["optim_history.dat"] + sorted(
                n for n in os.listdir(dh) if n.startswith("population"))
            if rt == "gradient":
                names.append("grad.dat")
            errs[rt] = file_errors(dc, dh, names)
            worst = max(errs[rt].values())
            if worst > TOL_CLI_REL:
                raise RuntimeError(f"CLI {rt} on the card against the CPU: "
                                   f"{json.dumps(errs[rt])}")
        phase(24, f"python -m quandary_tpu_torch config_template.cfg "
                  f"(complex128, fused_form {forms}, the time-parallel "
                  f"scan, no kernel launched; "
                  f"optimization at optim_maxiter {CLI_MAXITER}, "
                  f"optim_driver = {spec.optim_driver}: the host driver, so "
                  f"no device driver and no CUDA graph of it); wall s "
                  f"{json.dumps({k: round(v, 3) for k, v in walls.items()})}"
                  f"; largest error against the CPU per runtype "
                  f"{json.dumps({k: max(v.values()) for k, v in errs.items()})}"
                  f"; card: {smi}")
    return out


# Phase 25, the mid-size streamK pair (csrc/streamk_mid.cu): closed systems
# past one thread block. Kernel against plain on the card at MID_NT_CUT
# steps (the plain version of the N = 512 and 1024 sweeps materializes
# (ntime, N, N) planes and their cotangents), the full-width times at the
# configurations' 1000 steps.
MID_NT_CUT = 64
MID_CONFIGS = (("n256_pure", 256, "pure"), ("n256_basis", 256, "basis"),
               ("n512_pure", 512, "pure"), ("n1024_pure", 1024, "pure"))
MID = ("streamk_mid_fwd_launches", "streamk_mid_bwd_launches")
MID_SRC = "quandary_tpu_torch/csrc/streamk_mid.cu"
MID_FE_ITERS = 10       # device iterations of phase 25's front end
MID_FE_T = 2.0          # its horizon, ns (derived nsteps about 620)
FREQ3 = [4.8, 5.0, 5.2]


def swap02():
    """tests/test_api.py:95-125: SWAP between qubits 0 and 2 of three."""
    V = np.zeros((8, 8), dtype=complex)
    for i in range(8):
        b = [(i >> 2) & 1, (i >> 1) & 1, i & 1]
        V[(b[2] << 2) | (b[1] << 1) | b[0], i] = 1.0
    return V


def swap02_setup(ntime=MID_NT_CUT, T=6.0, fused=True, freq3=FREQ3,
                 guards=True, lindblad=False):
    """Three qubits with two guard levels each (N = 64, 8 basis states,
    one carrier per qubit, K = 7), the SWAP02 gate, split with 3
    iterations: what one block of streamk.cu refuses at B = 8. `freq3`
    detunes the qubits against the frame (a robust realization); without
    `guards` and with `lindblad` (T1 and T2 of QUTRITS) it is an open
    system of N = 8 with 64 basis density matrices, dimension 64 on the
    superop form."""
    Ne = [2, 2, 2]
    nlevels = [4, 4, 4] if guards else Ne
    model = build_standard_model(
        nlevels=nlevels, freq01_ghz=freq3, rotfreq_ghz=FREQ3,
        selfkerr_ghz=[0.22, 0.23, 0.24], jkl_ghz=[0.01, 0.004, 0.01],
        crosskerr_ghz=[],
        **(dict(decay_time=QUTRITS["decay"], dephase_time=QUTRITS["dephase"],
                lindblad=True) if lindblad else {}))
    oscs = tuple(OscillatorControl(
        segments=(ControlSegment("spline", nsplines=8, tstart=0.0,
                                 tstop=T),), carrier_freqs=(0.0,))
        for _ in range(3))
    return Setup(
        model=model, nessential=tuple(Ne), ntime=ntime, dt=T / ntime,
        oscillators=oscs, ground_freqs_radns=tuple(2 * np.pi * f
                                                   for f in FREQ3),
        initcond_type="basis", target_type="gate",
        target_gate_full=gates.assemble_gate(swap02(), nlevels, Ne,
                                             [0.0] * 3, T),
        objective_type="Jtrace", gamma_tik=1e-4, gamma_penalty=0.1,
        dtype=torch.complex64, linsolve_iters=3, linsolver="split",
        fused=fused)


def midsize_closed_setup(N, initcond, ntime=1000, fused=True, T=100.0,
                         linsolver="split", iters=4):
    """scripts/perf/midsize_bench.py:27-63 with the port's builders: two
    qudits (nlevels [16, 16], [16, 32], [32, 32]: N = 256, 512, 1024), T =
    100 ns, 1000 steps, split with 4 iterations, complex64; 'pure' (the
    ground state to a random state) or 'basis' (all N basis states to a
    random unitary). Phase 27's 'chunk' run shortens T and takes plain
    Neumann (`linsolver`, `iters`)."""
    nlevels = {256: [16, 16], 512: [16, 32], 1024: [32, 32]}[N]
    freq01 = [4.80595, 4.8601]
    model = build_standard_model(
        nlevels=nlevels, freq01_ghz=freq01, rotfreq_ghz=freq01,
        selfkerr_ghz=[0.2198, 0.2252], jkl_ghz=[0.005], crosskerr_ghz=[])
    oscs = tuple(OscillatorControl(
        segments=(ControlSegment("spline", nsplines=30, tstart=0.0,
                                 tstop=T),), carrier_freqs=(0.0,))
        for _ in range(2))
    rng = np.random.default_rng(42)
    if initcond == "basis":
        A = rng.normal(size=(N, N)) + 1j * rng.normal(size=(N, N))
        tgt = dict(target_type="gate", target_gate_full=np.linalg.qr(A)[0])
    else:
        v = rng.normal(size=N) + 1j * rng.normal(size=N)
        tgt = dict(target_type="state",
                   target_state_full=v / np.linalg.norm(v))
    return Setup(model=model, nessential=tuple(nlevels), ntime=ntime,
                 dt=T / ntime, oscillators=oscs,
                 ground_freqs_radns=tuple(2 * np.pi * f for f in freq01),
                 initcond_type=initcond, objective_type="Jtrace",
                 gamma_tik=1e-4, dtype=torch.complex64, linsolve_iters=iters,
                 linsolver=linsolver, fused=fused, **tgt)


def mid_same_bits(plan, x0r, x0i, C, rng):
    """Two launches of each mid kernel on the same inputs give the same
    bits (no float atomics; C-bar partials summed in a fixed order)."""
    a = streamk_mid._kernel_fwd(plan, x0r, x0i, C)
    b = streamk_mid._kernel_fwd(plan, x0r, x0i, C)
    same = all((u is None and v is None) or torch.equal(u, v)
               for u, v in zip(a, b))
    w = lambda t: torch.as_tensor(rng.normal(size=tuple(t.shape)),
                                  device="cuda", dtype=torch.float32)
    gT, gh = w(a[0]), w(a[2])
    bw = [streamk_mid._kernel_bwd(plan, x0r, x0i, C, *a[2:], gT, gT, gh, gh)
          for _ in range(2)]
    return same and all(torch.equal(u, v) for u, v in zip(*bw))


def mid_bwd_checks(plan, x0r, x0i, C, rng):
    """The mid backward's schedules and iterate modes on the same inputs
    and cotangents: the planner's schedule ('helpers' at phase 25's B = 1
    sizes) against the other ('chain', forced), g0 in the same bits and
    C-bar's largest difference relative to its largest entry; and, on the
    planner's schedule, g0 and C-bar in the same bits whether the forward
    stored its stage iterates or the backward replays them. Returns the
    report and the (schedule, layout) pairs driven."""
    w = lambda t: torch.as_tensor(rng.normal(size=tuple(t.shape)),
                                  device="cuda", dtype=torch.float32)
    runs, seen, shapes = {}, set(), {}
    gT = gh = None
    for store in (True, False):
        p = dataclasses.replace(plan, store_iters=store)
        a = streamk_mid._kernel_fwd(p, x0r, x0i, C)
        if gT is None:
            gT, gh = w(a[0]), w(a[2])
        for sched in ((None, "chain") if store else (None,)):
            key = (store, sched or "planner")
            runs[key] = streamk_mid._kernel_bwd(p, x0r, x0i, C, *a[2:], gT,
                                                gT, gh, gh, _schedule=sched)
            shapes[f"{'stored' if store else 'replayed'}_{key[1]}"] = dict(
                streamk_mid.mid_layouts["bwd"])
            lay = streamk_mid.mid_layouts["bwd"]
            seen.add(("schedule", lay["schedule"], lay["layout"]))
    torch.cuda.synchronize()
    planner, chain = runs[(True, "planner")], runs[(True, "chain")]
    return dict(
        schedules_g0_bits=torch.equal(planner[0], chain[0])
        and torch.equal(planner[1], chain[1]),
        schedules_cbar_rel=float((planner[2] - chain[2]).abs().max()
                                 / chain[2].abs().max()),
        stored_replayed=all(torch.equal(u, v) for u, v in
                            zip(planner, runs[(False, "planner")])),
        shapes=shapes), seen


def mid_fwd_checks(plan, x0r, x0i, C, rng):
    """The mid forward's schedules on the same inputs (C at full depth):
    the planner's schedule against the other one forced ('chain' where the
    planner takes 'helpers', else 'helpers'): xT, the history and the
    stored iterates in the same bits, and the backward (on its planner's
    schedule) from either forward's outputs with the same cotangents, g0
    and C-bar in the same bits; both forwards timed with CUDA events in
    the order other, planner, planner, other."""
    runs = {"planner": lambda: streamk_mid._kernel_fwd(plan, x0r, x0i, C)}
    out = {"planner": runs["planner"]()}
    shape = dict(streamk_mid.mid_layouts["fwd"])
    other = "chain" if shape["schedule"] == "helpers" else "helpers"
    runs[other] = lambda: streamk_mid._kernel_fwd(plan, x0r, x0i, C,
                                                  _schedule=other)
    out[other] = runs[other]()
    other_shape = dict(streamk_mid.mid_layouts["fwd"])
    w = lambda t: torch.as_tensor(rng.normal(size=tuple(t.shape)),
                                  device="cuda", dtype=torch.float32)
    gT, gh = w(out["planner"][0]), w(out["planner"][2])
    bwd = {k: streamk_mid._kernel_bwd(plan, x0r, x0i, C, *f[2:], gT, gT, gh,
                                      gh) for k, f in out.items()}
    ms = {k: [] for k in runs}
    for k in (other, "planner", "planner", other):
        ms[k].append(event_ms(runs[k], 1))
    torch.cuda.synchronize()
    mean = {k: statistics.mean(v) for k, v in ms.items()}
    return dict(
        schedule=shape["schedule"], helpers=shape["helpers"], shape=shape,
        other=other, other_shape=other_shape, ms=ms,
        ratio=mean["planner"] / mean[other],
        bits=all((a is None and b is None) or torch.equal(a, b)
                 for a, b in zip(out["planner"], out[other])),
        bwd_bits=all(torch.equal(a, b) for a, b in zip(*bwd.values())))


def fwd_schedules_ok(rep, schedule):
    """A mid_fwd_checks report on the expected planner schedule (None: the
    card's count of clusters decides), with the other schedule's bits
    forward and backward."""
    return (schedule in (None, rep["schedule"]) and rep["bits"]
            and rep["bwd_bits"])


def mid_phase(smi, flagship_plan):
    """Phase 25: the mid pair against plain, its layouts and determinism,
    Problem through it at full width, and Quandary on a system past one
    block."""
    if streamk.uses_mid(flagship_plan, 4, 16):
        raise RuntimeError("the flagship would take the mid pair")
    rng = np.random.default_rng(25)
    setups = {"n64": swap02_setup}
    for name, N, init in MID_CONFIGS:
        setups[name] = functools.partial(midsize_closed_setup, N, init)
    probs = {name: Problem(fn()) for name, fn in setups.items()}
    to_card = lambda a: torch.as_tensor(a, device="cuda", dtype=torch.float32)
    errs, seen, worst = {}, set(), dict(state=0.0, cbar=0.0, x0bar=0.0,
                                        cbar_rel=0.0, x0bar_rel=0.0)
    bits, plain_cut = {}, {}
    for name, pr in probs.items():
        if not pr.fused_ok or not streamk.uses_mid(pr._plan, pr.ninit, pr.N):
            raise RuntimeError(f"{name}: not on the mid pair: "
                               f"{pr.fused_refusal}")
        for E in ((1, 4) if name == "n64" else (1,)):
            P = to_card(bench_params(pr.setup.nparams, E,
                                     seed=int(rng.integers(1 << 30))))
            C = streamk.extend_coeffs(
                pr._plan, pr.coeff_rows_mid(P)[:, :MID_NT_CUT, 0, :])
            for store in (True, False):
                plan = dataclasses.replace(pr._plan, store_iters=store)
                reset_counts()
                err = compare_plan(plan, pr, C, rng)
                sweep_launches(MID)
                key = f"{name}_E{E}_{'stored' if store else 'replay'}"
                errs[key] = dict(err, fwd=streamk_mid.mid_layouts["fwd"],
                                 bwd=streamk_mid.mid_layouts["bwd"])
                print(f"  {key}: {json.dumps(errs[key])}", flush=True)
                for k in worst:
                    worst[k] = max(worst[k], err[k])
                seen.add(("fwd", streamk_mid.mid_layouts["fwd"]["layout"]))
                seen.add(("bwd", streamk_mid.mid_layouts["bwd"]["layout"],
                          store))
                seen.add(("Bc", streamk_mid.mid_layouts["fwd"]["Bc"]))
                seen.add(("schedule", streamk_mid.mid_layouts["bwd"][
                    "schedule"], streamk_mid.mid_layouts["bwd"]["layout"]))
                seen.add(("fwd_schedule", streamk_mid.mid_layouts["fwd"][
                    "schedule"], streamk_mid.mid_layouts["fwd"]["layout"]))
                bits[key] = mid_same_bits(plan, pr._x0r, pr._x0i, C, rng)
                if E == 1 and store == pr._plan.store_iters:
                    plain_cut[name] = kernel_ms(plan, pr._x0r, pr._x0i, C,
                                                1, 1, plain_warm=False)
    # the backward's schedules against each other and stored against
    # replayed iterates, at two sizes where both modes take one shape
    sched = {}
    for name in ("n256_pure", "n1024_pure"):
        pr = probs[name]
        P = to_card(bench_params(pr.setup.nparams, 1,
                                 seed=int(rng.integers(1 << 30))))
        C = streamk.extend_coeffs(
            pr._plan, pr.coeff_rows_mid(P)[:, :MID_NT_CUT, 0, :])
        sched[name], more = mid_bwd_checks(pr._plan, pr._x0r, pr._x0i, C,
                                           rng)
        seen |= more
    # the forward's schedules against each other at full depth: bits, the
    # backward from either, interleaved times ('helpers' at B = 1)
    fsched = {}
    for name in ("n256_pure", "n512_pure", "n1024_pure", "n256_basis"):
        pr = probs[name]
        P = to_card(bench_params(pr.setup.nparams, 1,
                                 seed=int(rng.integers(1 << 30))))
        C = streamk.extend_coeffs(pr._plan, pr.coeff_rows_mid(P)[:, :, 0, :])
        fsched[name] = mid_fwd_checks(pr._plan, pr._x0r, pr._x0i, C, rng)
        for k in ("shape", "other_shape"):
            seen.add(("fwd_schedule", fsched[name][k]["schedule"],
                      fsched[name][k]["layout"]))
        print(f"  {name} forward schedules: {json.dumps(fsched[name])}",
              flush=True)
        del C
    want = {("fwd", "smem"), ("fwd", "global"), ("bwd", "smem", True),
            ("bwd", "smem", False), ("bwd", "global", True),
            ("bwd", "global", False), ("Bc", 1), ("Bc", 8),
            ("schedule", "helpers", "smem"), ("schedule", "helpers", "global"),
            ("schedule", "chain", "smem"), ("schedule", "chain", "global"),
            ("fwd_schedule", "helpers", "smem"),
            ("fwd_schedule", "helpers", "global"),
            ("fwd_schedule", "chain", "smem"),
            ("fwd_schedule", "chain", "global")}
    bad = [k for k, e in errs.items()
           if e["state"] > TOL_STATE_ABS or e["cbar_rel"] > TOL_GRAD_REL
           or e["x0bar_rel"] > TOL_GRAD_REL]
    bad += [f"{k}: schedules" for k, v in sched.items()
            if not v["schedules_g0_bits"]
            or v["schedules_cbar_rel"] > TOL_GRAD_REL]
    bits.update({f"{k}_stored_replayed": v["stored_replayed"]
                 for k, v in sched.items()})
    bits.update({f"{k}_fwd_schedules": v["bits"] and v["bwd_bits"]
                 for k, v in fsched.items()})
    bad += [f"{k}: forward on {v['schedule']}" for k, v in fsched.items()
            if (v["schedule"] == "helpers") != (k != "n256_basis")]
    phase(25, f"mid pair == plain at {MID_NT_CUT} steps within abs "
              f"{TOL_STATE_ABS} (states), {TOL_GRAD_REL} x max (cotangents):"
              f" worst {json.dumps(worst)}; out of bounds {bad}; layouts "
              f"and schedules {sorted(map(str, seen))}; missing "
              f"{sorted(map(str, want - seen))}"
              f"; same bits on repeat, stored_replayed and the forward's "
              f"schedules {json.dumps(bits)}; the backward's schedules (g0 "
              f"bits, C-bar x max) and shapes {json.dumps(sched)}; the "
              f"forward's schedules, 1000 steps, ms (planner / other, "
              f"interleaved): " + "; ".join(
                  f"{k} {v['schedule']} + {v['helpers']} helpers "
                  f"{statistics.mean(v['ms']['planner']):.3f} / "
                  f"{v['other']} {statistics.mean(v['ms'][v['other']]):.3f}"
                  f" ({v['ratio']:.3f}x)" for k, v in fsched.items()))
    if bad or want - seen or not all(bits.values()):
        raise RuntimeError(f"mid pair: out of bounds {bad}, layouts not "
                           f"driven {want - seen}, bits {bits}")

    # Problem through the mid pair, fused=True and 'auto', at full width
    # (N = 64: its MID_NT_CUT steps)
    full, launches = {}, {k: 0 for k in MID}
    for name, setup_fn in setups.items():
        pr = probs[name]
        auto = Problem(setup_fn(fused="auto"))
        if not (auto.use_fused and auto.fused_form == "streamk"
                and pr.fused_form == "streamk" and auto.fused_ok):
            raise RuntimeError(f"{name}: fused=True / 'auto' did not take "
                               "the streamK route")
        x = bench_params(pr.setup.nparams)
        vg = pr.build_value_and_grad()
        reset_counts()
        (J, aux), g = vg(x, x)
        torch.cuda.synchronize()
        got = sweep_launches(MID)
        for k in MID:
            launches[k] += got[k]
        if not (torch.isfinite(J) and bool(torch.isfinite(g).all())):
            raise RuntimeError(f"{name}: non-finite value_and_grad")
        (Ja, _), ga = auto.build_value_and_grad()(x, x)
        if float(Ja) != float(J) or not torch.equal(ga, g):
            raise RuntimeError(f"{name}: fused='auto' and True differ")
        del auto
        rate = 1.0 / median_seconds(lambda: vg(x, x), reps=3)
        C = streamk.extend_coeffs(pr._plan, pr.coeff_rows_mid(
            to_card(x))[None, :, 0])
        t = kernel_ms(pr._plan, pr._x0r, pr._x0i, C, 3,
                      1 if name == "n256_pure" else 0, plain_warm=False)
        t.update({f"{k}_shape": dict(streamk_mid.mid_layouts[k])
                  for k in ("fwd", "bwd")})
        if name.endswith("_pure") and t["fwd_shape"]["schedule"] != \
                "helpers":
            raise RuntimeError(f"{name}: the forward ran on "
                               f"{t['fwd_shape']['schedule']}, not 'helpers'")
        full[name] = dict(t, sweeps_per_s=rate, J=float(J),
                          fidelity=float(aux["fidelity"]),
                          stored=pr._plan.store_iters, B=pr.ninit, N=pr.N)
        print(f"  {name} ntime {pr.setup.ntime}: {json.dumps(full[name])}",
              flush=True)
    phase(25, f"Problem (fused=True and 'auto') on the mid pair at full "
              f"width, 1 + 1 launches per sweep: "
              + "; ".join(f"{k}: {v['sweeps_per_s']:.3f} sweeps/s, fwd / "
                          f"bwd {v['fwd']:.3f} / {v['bwd']:.3f} ms (bound "
                          f"{v['fwd_bound'][0]:.4f} / {v['bwd_bound'][0]:.4f}"
                          f"), G / Bc fwd {v['fwd_shape']['G']} / "
                          f"{v['fwd_shape']['Bc']} bwd {v['bwd_shape']['G']} "
                          f"/ {v['bwd_shape']['Bc']}"
                          for k, v in full.items()) + f"; card: {smi}")

    # the front end on a system past one block
    kw = dict(Ne=[2, 2, 2], Ng=[2, 2, 2], freq01=FREQ3, rotfreq=FREQ3,
              selfkerr=[0.22, 0.23, 0.24], Jkl=[0.01, 0.004, 0.01],
              T=MID_FE_T, targetgate=swap02(), rand_seed=1234,
              initctrl_MHz=5.0,
              carrier_frequency=[[0.0, FREQ3[1] - FREQ3[0]],
                                 [0.0, FREQ3[0] - FREQ3[1]],
                                 [0.0, FREQ3[1] - FREQ3[2]]])
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        q32 = Quandary(precision="single", optimizer="device",
                       maxiter=MID_FE_ITERS, **kw)
        q64 = Quandary(precision="double", device="cpu", **kw)
        s32 = q32._build_setup()
        p32 = q32._problem(s32)
        if p32.fused_form != "streamk" or not streamk.uses_mid(
                p32._plan, p32.ninit, p32.N):
            raise RuntimeError(f"SWAP02 (N = {p32.N}) took route "
                               f"{p32.fused_form}, not the mid pair")
        p0 = q32._initial_params(s32.oscillators)
        reset_counts()
        t0 = time.perf_counter()
        r32 = q32.simulate(pcof0=p0, datadir=os.path.join(tmp, "sim32"))
        torch.cuda.synchronize()
        t_sim = time.perf_counter() - t0
        sim = main_path_launches(MID[:1])
        t0 = time.perf_counter()
        r64 = q64.simulate(pcof0=p0, datadir=os.path.join(tmp, "sim64"))
        t_sim64 = time.perf_counter() - t0
        fe_err = front_end_errors(r32, r64)
        reset_counts()
        t0 = time.perf_counter()
        q32.optimize(pcof0=p0, datadir=os.path.join(tmp, "opt32"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        opt = main_path_launches(MID)
        cost = q32.optim_hist["Cost"]
        niter = len(q32.optim_hist["Iters"]) - 1
        sweeps = device_sweeps(niter)
    fe = dict(N=p32.N, B=p32.ninit, K=p32.model.K, nsteps=q32.nsteps,
              linsolver=p32.linsolver, iters=p32._plan.iters,
              stored=p32._plan.store_iters, simulate_s=t_sim,
              simulate_f64_cpu_s=t_sim64, errors=fe_err, iterations=niter,
              cost_first=cost[0], cost_last=cost[-1], optimize_s=wall,
              launches_simulate=sim, launches_optimize=opt,
              shapes=dict(streamk_mid.mid_layouts))
    phase(25, f"Quandary(precision='single') SWAP02 with Ng = [2, 2, 2]: "
              f"{json.dumps(fe)}; card: {smi}")
    if fe_err["infidelity"] > TOL_MID_FE_INFID \
            or fe_err["energy"] > TOL_MID_FE_TRAJ \
            or fe_err["population"] > TOL_MID_FE_TRAJ \
            or sim[MID[0]] != 1 or sim[MID[1]] != 0 \
            or opt[MID[0]] != sweeps or opt[MID[1]] != sweeps \
            or not cost[-1] < cost[0]:
        raise RuntimeError(f"SWAP02 front end: errors {fe_err}, launches "
                           f"{sim} / {opt} ({sweeps} sweeps), cost "
                           f"{cost[0]} -> {cost[-1]}")
    return dict(worst=worst, full=full, plain_cut=plain_cut,
                launches=launches, fe=fe, schedules=sched,
                fwd_schedules=fsched)


# Phase 26, the mid-size density-matrix pair (csrc/rho_mid_fwd.cu,
# csrc/rho_mid.cu): open systems of 64 < N <= 128. Kernel against plain on
# the card at NT_SHORT steps over the solvers, with and without jump
# operators, stored and replayed iterates, at two cluster sizes each
# (RHO_MID_CASES: solver, least dt divisor, jump operators, stored, G);
# plain Neumann at dt/8 or finer, where its series converges, dt/2 |d| <=
# 1/2 on the stiffest entry of the generator's diagonal (qudits128's
# 16-level qudit needs dt/32: at dt/8 both f32 versions and the f64 one
# grow past 1e8); qudits125 and qudits128 at full depth; the front end on
# qudits125's physics.
RHO_MID = ("rho_mid_fwd_launches", "rho_mid_bwd_launches")
RHO_MID_SRC = "quandary_tpu_torch/csrc/rho_mid.cu"
RHO_MID_FWD_SRC = "quandary_tpu_torch/csrc/rho_mid_fwd.cu"
RHO_MID_CHECK_N = (65, 96, 125, 128)
RHO_MID_CASES = (("jacobi", 1, True, True, None), ("jacobi", 1, True, False, 8),
                 ("jacobi", 1, False, True, 8), ("split", 1, True, True, 8),
                 ("split", 1, False, False, None),
                 ("neumann", 8, True, False, 8),
                 ("neumann", 8, False, True, None))
RHO_MID_FE_T = 0.1      # the front end's horizon, ns (derived nsteps 60)
RHO_MID_FE_ITERS = 2    # its device iterations
# Its bounds against precision="double" on the CPU, about 5x the errors
# measured on an H100 80GB HBM3 (700 W) at T = 0.2 ns (120 steps):
# infidelity 1.4e-9, expected energy and population 3.2e-7 abs; at this
# T = 0.1 ns the same card read 2.9e-9 and 3.2e-7
TOL_RHO_MID_FE_INFID = 1e-8
TOL_RHO_MID_FE_TRAJ = 2e-6
# qudits125's value_and_grad, bounds about 5x the errors measured on an H100
# 80GB HBM3 (700 W): against plain at NT_SHORT steps J 0, gradient 7.1e-7 x
# max; against the f64 port at NT_F64 steps J 3.7e-7, gradient 2.1e-6 x max
TOL_OPEN["qudits125"] = dict(J_plain=1e-6, g_plain=5e-6, J_f64=2e-6,
                             g_f64=1e-5)


def rho_mid_fe_kwargs():
    """Quandary's arguments for phase 26's front end: qudits125's physics
    (Ne = [3, 3, 3] with Ng = [2, 2, 2]), '3states', a random pure target
    state on the essential levels, carriers at 0."""
    rng = np.random.default_rng(42)
    tgt = rng.normal(size=27) + 1j * rng.normal(size=27)
    return dict(Ne=[3, 3, 3], Ng=[2, 2, 2], freq01=QUTRITS["freq01"],
                rotfreq=QUTRITS["freq01"], selfkerr=QUTRITS["selfkerr"],
                Jkl=QUTRITS["jkl"], T1=QUTRITS["decay"],
                T2=QUTRITS["dephase"], initialcondition="3states",
                targetstate=tgt / np.linalg.norm(tgt),
                carrier_frequency=[[0.0]] * 3, T=RHO_MID_FE_T,
                rand_seed=1234)


def cpu_references(path):
    """The worker phase 2 starts (python3 chip_smoke.py --cpu-references
    FILE): on the CPU only, first phase 14's f64 value_and_grad of open
    configurations 2 and 3 at NT_F64 steps, pickled to FILE.open14; then
    qudits125's at NT_F64 steps and the front end's precision="double"
    simulate for phase 26, pickled to FILE; last phase 29's f64 gradient of
    Quandary at N = 1296, pickled to FILE.large_n."""
    import pickle
    torch.set_num_threads(4)

    def dump(obj, dest):
        with open(dest + ".tmp", "wb") as f:
            pickle.dump(obj, f)
        os.replace(dest + ".tmp", dest)

    dump({name: f64_reference(name, ntime=NT_F64) for name in OPEN14},
         path + ".open14")
    out = {}
    out["qudits125"] = f64_reference("qudits125", ntime=NT_F64)
    q64 = Quandary(precision="double", device="cpu", **rho_mid_fe_kwargs())
    p0 = q64._initial_params(q64._build_setup().oscillators)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        t0 = time.perf_counter()
        r64 = q64.simulate(pcof0=p0, datadir=tmp)
    out["front_end"] = dict(p0=p0, result=r64,
                            seconds=time.perf_counter() - t0)
    dump(out, path)
    # phase 29(e): Quandary at N = 1296 in f64
    dump(large_n_reference(), path + ".large_n")


def worker_references(worker, path, timeout=900):
    """What the CPU reference worker pickled to `path`, once it is there;
    raises if the worker ended without writing it or took past
    `timeout` seconds."""
    import pickle
    t0 = time.perf_counter()
    while not os.path.exists(path):
        if worker.poll() is not None and not os.path.exists(path):
            raise RuntimeError(f"the CPU reference worker ended "
                               f"({worker.returncode}) without {path}")
        if time.perf_counter() - t0 > timeout:
            raise RuntimeError(f"the CPU reference worker did not write "
                               f"{path} in {timeout} s")
        time.sleep(0.2)
    with open(path, "rb") as f:
        return pickle.load(f)


def rho_mid_compare(plan, x0r, x0i, C, rng, store, G):
    """One launch of each mid kernel on cluster size G (None: the rule's)
    against rho.plain_forward / plain_backward on the same inputs (the
    backward's: the kernel's history and random cotangents): max abs errors
    of the states, C-bar and x0-bar, the relative ones, the states of both
    against the plain version in f64 on the card; exactly 1 + 1 mid
    launches. With replayed iterates the backward runs on the schedule the
    planner picks and once more on the other one ('split' / 'chain'), whose
    outputs must have the same bits (`schedules_equal`)."""
    E, nt = C.shape[:2]
    w = lambda *s: torch.as_tensor(rng.normal(size=s), device="cuda",
                                   dtype=torch.float32)
    gT, jr, ji = w(E, *x0r.shape), w(E, nt, *x0r.shape), w(E, nt, *x0r.shape)
    reset_counts()
    with iterates_budget((1 << 62) if store else 0):
        fwd = rho._kernel_fwd(plan, x0r, x0i, C, _cluster=G)
        g0r, g0i, Cb = rho._kernel_bwd(plan, x0r, x0i, C, *fwd[2:], gT, gT,
                                       jr, ji, _cluster=G)
    torch.cuda.synchronize()
    sweep_launches(RHO_MID)
    if (fwd[4] is not None) != store:
        raise RuntimeError(f"rho_mid_fwd stored iterates: {fwd[4] is not None}")
    shapes = {k: dict(rho_mid.mid_layouts[k]) for k in ("fwd", "bwd")}
    same = True
    if not store:
        other = {"split": "chain", "chain": "split"}[shapes["bwd"]["schedule"]]
        got = rho_mid._kernel_bwd(plan, x0r, x0i, C, *fwd[2:], gT, gT, jr, ji,
                                  _cluster=G, _schedule=other)
        same = all(torch.equal(a, b) for a, b in zip(got, (g0r, g0i, Cb)))
    flat = lambda ts: torch.cat([t.flatten() for t in ts])
    with torch.no_grad():
        ph = rho.plain_forward(plan, x0r, x0i, C)
        pb = rho.plain_backward(plan, x0r, x0i, C, fwd[2], fwd[3], gT, gT,
                                jr, ji)
        d = lambda t: None if t is None else t.double()
        plan64 = dataclasses.replace(plan, Sr=d(plan.Sr), Si=d(plan.Si),
                                     L=d(plan.L), planes=d(plan.planes))
        s64 = flat(rho.plain_forward(plan64, x0r.double(), x0i.double(),
                                     C.double()))
    sk, sp = flat(fwd[2:4]), flat(ph)
    xk, xp = flat((g0r, g0i)), flat(pb[:2])
    if not all(bool(torch.isfinite(t).all()) for t in (sk, xk, Cb)):
        raise RuntimeError("rho_mid kernel produced non-finite values")
    return dict(state=float((sk - sp).abs().max()),
                cbar=float((Cb - pb[2]).abs().max()),
                x0bar=float((xk - xp).abs().max()),
                cbar_rel=max_rel(Cb, pb[2]), x0bar_rel=max_rel(xk, xp),
                kernel_f64=float((sk - s64).abs().max()),
                plain_f64=float((sp - s64).abs().max()),
                G=shapes["fwd"]["G"], schedules_equal=same, shapes=shapes)


def rho_mid_bits(plan, x0r, x0i, C, rng):
    """The mid pair's bits: xT, hist, the stored iterates and g0 equal at
    G = 8 and 16 (Cb's difference relative to its max), g0 and Cb equal
    from stored and from replayed iterates on both of the backward's
    schedules ('split' and 'chain') at each G, and on a repeat."""
    E, nt = C.shape[:2]
    w = lambda *s: torch.as_tensor(rng.normal(size=s), device="cuda",
                                   dtype=torch.float32)
    gT, jh = w(E, *x0r.shape), w(E, nt, *x0r.shape)
    out = {}
    with iterates_budget(1 << 62):
        for G in (8, 16):
            fwd = rho._kernel_fwd(plan, x0r, x0i, C, _cluster=G)
            out[G] = (fwd, rho._kernel_bwd(plan, x0r, x0i, C, *fwd[2:], gT,
                                           gT, jh, jh, _cluster=G))
        fwd = out[16][0]
        replay = [rho._kernel_bwd(plan, x0r, x0i, C, fwd[2], fwd[3], None,
                                  None, gT, gT, jh, jh) for _ in range(2)]
        again = rho._kernel_fwd(plan, x0r, x0i, C)
        scheds = {(G, s): rho_mid._kernel_bwd(
            plan, x0r, x0i, C, fwd[2], fwd[3], None, None, gT, gT, jh, jh,
            _cluster=G, _schedule=s) for G in (8, 16)
            for s in ("split", "chain")}
    eq = lambda a, b: all(torch.equal(u, v) for u, v in zip(a, b))
    return dict(
        fwd_G8_G16=eq(out[8][0], out[16][0]),
        g0_G8_G16=eq(out[8][1][:2], out[16][1][:2]),
        cbar_G8_G16_rel=max_rel(out[8][1][2], out[16][1][2]),
        stored_replayed=eq(out[16][1], replay[0]),
        stored_split_chain=all(eq(out[G][1], v)
                               for (G, _), v in scheds.items()),
        repeat=eq(replay[0], replay[1]) and eq(again, fwd))


def rho_mid_wide(pr, rng, E=8, G=16):
    """The backward's 'split' schedule past what the card holds at once: E
    candidates of `pr`'s B matrices (E B = 24 at qudits125's shape) on
    clusters of G CTAs, at NT_SHORT steps, replayed iterates: 2 E B
    clusters against the card's count, against plain_backward (C-bar and
    x0-bar relative to their max), and its bits against the 'chain'
    schedule's; the wall of its launch."""
    to_card = lambda a: torch.as_tensor(a, device="cuda", dtype=torch.float32)
    P = to_card(bench_params(pr.setup.nparams, E, seed=24))
    C = pr.coeff_rows_mid(P)[..., 0, :].contiguous()
    plan, x0r, x0i = pr._plan, pr._x0r, pr._x0i
    with iterates_budget(0):
        fwd = rho._kernel_fwd(plan, x0r, x0i, C)
    w = lambda *s: torch.as_tensor(rng.normal(size=s), device="cuda",
                                   dtype=torch.float32)
    nt = C.shape[1]
    gT, jh = w(E, *x0r.shape), w(E, nt, *x0r.shape)
    args = (plan, x0r, x0i, C, fwd[2], fwd[3], None, None, gT, gT, jh, jh)
    lib = rho_mid._lib()
    shape = rho_mid.launch_shape(lib, True, plan, E, x0r.shape[0], G)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    split = rho_mid._kernel_bwd(*args, _cluster=G, _schedule="split")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    layout = dict(rho_mid.mid_layouts["bwd"])
    chain = rho_mid._kernel_bwd(*args, _cluster=G, _schedule="chain")
    with torch.no_grad():
        plain = rho.plain_backward(plan, x0r, x0i, C, fwd[2], fwd[3], gT, gT,
                                   jh, jh)
    torch.cuda.synchronize()
    return dict(EB=E * x0r.shape[0], G=G, nt=nt,
                holds=rho_mid.holds(lib, True, shape), layout=layout,
                split_s=wall, split_chain_equal=all(
                    torch.equal(a, b) for a, b in zip(split, chain)),
                finite=all(bool(torch.isfinite(t).all()) for t in split),
                x0bar_rel=max_rel(torch.cat([split[0].flatten(),
                                             split[1].flatten()]),
                                  torch.cat([plain[0].flatten(),
                                             plain[1].flatten()])),
                cbar_rel=max_rel(split[2], plain[2]))


def rho_mid_phase(smi, worker, ref_path):
    """Phase 26: the mid density-matrix pair against plain, its bits,
    qudits125 through Problem at full depth, qudits128's times and the
    front end on qudits125's physics."""
    import pickle
    rng = np.random.default_rng(26)
    to_card = lambda a: torch.as_tensor(a, device="cuda", dtype=torch.float32)
    short = {N: Problem(midsize_setup(N, ntime=NT_SHORT))
             for N in RHO_MID_CHECK_N}
    worst = dict(state=0.0, cbar=0.0, x0bar=0.0, cbar_rel=0.0,
                 x0bar_rel=0.0, kernel_f64=0.0)
    bad, clusters = [], set()
    for N, pr in short.items():
        if pr.fused_form != "rho" or pr.linsolver != "jacobi" \
                or not rho.uses_mid(N, pr.model.K, len(pr.engine.Ls_np), 1,
                                    pr.ninit):
            raise RuntimeError(f"N = {N}: route {pr.fused_form}, solver "
                               f"{pr.linsolver}; expected the mid rho pair")
        st, it = pr.setup, pr.setup.linsolve_iters
        stiff = 0.5 * st.dt * float(np.abs(pr.gen_diag).max())
        for solver, div, jumps, store, G in RHO_MID_CASES:
            while solver == "neumann" and stiff / div > 0.5:
                div *= 2
            plan = rho.make_plan(pr._Sr, pr._Si,
                                 pr.engine.Ls_np if jumps else None,
                                 st.dt / div, it, pr.gen_diag, solver)
            P = to_card(bench_params(st.nparams, 1,
                                     seed=int(rng.integers(1 << 30))))
            C = pr.coeff_rows_mid(P)[..., 0, :].contiguous()
            err = rho_mid_compare(plan, pr._x0r, pr._x0i, C, rng, store, G)
            shapes = err.pop("shapes")
            clusters.add((N, err["G"]))
            print(f"  rho_mid N={N} {solver}-{it} dt/{div} jumps="
                  f"{plan.njump} stored={store}: {json.dumps(err)} "
                  f"{json.dumps(shapes)}", flush=True)
            for k in worst:
                worst[k] = max(worst[k], err[k])
            if err["state"] > TOL_RHO_STATE_ABS \
                    or err["cbar_rel"] > TOL_RHO_GRAD_REL \
                    or err["x0bar_rel"] > TOL_RHO_GRAD_REL \
                    or not err["schedules_equal"] \
                    or err["kernel_f64"] > max(TOL_RHO_F64_ABS,
                                               err["plain_f64"]):
                bad.append((N, solver, div, jumps, store, G, err))
    wide = rho_mid_wide(short[125], rng)
    phase(26, f"rho_mid_bwd 'split' at E B = {wide['EB']} on clusters of "
              f"{wide['G']} (the card holds {wide['holds']} of the "
              f"{wide['layout']['clusters']}): {json.dumps(wide)}; bounds "
              f"{TOL_RHO_GRAD_REL} x max, the 'chain' schedule's bits")
    if not (wide["split_chain_equal"] and wide["finite"]
            and wide["holds"] < wide["layout"]["clusters"]
            and max(wide["x0bar_rel"], wide["cbar_rel"]) <= TOL_RHO_GRAD_REL):
        raise RuntimeError(f"rho_mid_bwd at E B = {wide['EB']}: {wide}")
    pr = short[128]
    plan = rho.make_plan(pr._Sr, pr._Si, pr.engine.Ls_np, pr.setup.dt, 6,
                         pr.gen_diag, "jacobi")
    C = pr.coeff_rows_mid(to_card(bench_params(pr.setup.nparams, 1,
                                               seed=5)))[..., 0, :]
    bits = rho_mid_bits(plan, pr._x0r, pr._x0i, C.contiguous(), rng)
    phase(26, f"rho_mid pair == plain at {NT_SHORT} steps within abs "
              f"{TOL_RHO_STATE_ABS} (states), {TOL_RHO_GRAD_REL} x max "
              f"(cotangents), and within {TOL_RHO_F64_ABS} of plain f64 or "
              f"closer than plain f32; worst {json.dumps(worst)}; clusters "
              f"(N, G) {sorted(clusters)}; out of bounds {bad}; bits "
              f"{json.dumps(bits)}")
    if bad or not all(v for k, v in bits.items() if k != "cbar_G8_G16_rel") \
            or bits["cbar_G8_G16_rel"] > 1e-6 \
            or len({G for _, G in clusters}) < 2:
        raise RuntimeError(f"rho_mid pair: out of bounds {bad}, bits {bits}, "
                           f"clusters {clusters}")

    # qudits125 through Problem at full depth (fused=True and 'auto'),
    # qudits128's kernel times
    full, report, launches = {}, {}, None
    for name in ("qudits125", "qudits128"):
        fn = OPEN_CONFIGS[name]
        p = Problem(fn())
        auto = Problem(fn(fused="auto"))
        if not (p.fused_form == auto.fused_form == "rho" and p.fused_ok
                and auto.use_fused and auto.fused_ok):
            raise RuntimeError(f"{name}: fused=True / 'auto' took "
                               f"{p.fused_form} / {auto.fused_form}")
        P = to_card(bench_params(p.setup.nparams))[None]
        reset_counts()
        got = open_vg(p, P)
        torch.cuda.synchronize()
        counts = sweep_launches(RHO_MID)
        gota = open_vg(auto, P)
        if not all(torch.equal(a, b) for a, b in zip(got, gota)):
            raise RuntimeError(f"{name}: fused='auto' and True differ")
        del auto
        if not (bool(torch.isfinite(got[0]).all())
                and bool(torch.isfinite(got[2]).all())):
            raise RuntimeError(f"{name}: non-finite value_and_grad")
        C = p.coeff_rows_mid(P)[..., 0, :].contiguous()
        report[name] = dict(N=p.N, K=p.model.K, J=len(p.engine.Ls_np),
                            ninit=p.ninit, ntime=p.setup.ntime,
                            J_value=float(got[0][0]),
                            fidelity=float(got[1][0]), launches=counts)
        if name == "qudits125":
            launches = counts
            ps = short[125]
            got_s = open_vg(ps, P)
            with plain_on_card():
                plain_s = open_vg(ps, P)
            report[name]["plain_short"] = open_errors(got_s, plain_s)
            report[name]["sweeps_per_s"] = 1.0 / median_seconds(
                lambda: open_vg(p, P), reps=3)
            full[name] = rho_kernel_ms(p._plan, p._x0r, p._x0i, C, 2,
                                       plain=True)
            got_m = open_vg(Problem(fn(ntime=NT_F64)), P)
        else:
            full[name] = rho_kernel_ms(p._plan, p._x0r, p._x0i, C, 2,
                                       plain=False)
        del p
    # the f64 references the worker computed on the host meanwhile
    try:
        worker.wait(timeout=900)
    except subprocess.TimeoutExpired:
        raise RuntimeError("the CPU reference worker did not finish")
    if worker.returncode != 0:
        raise RuntimeError(f"the CPU reference worker failed "
                           f"({worker.returncode})")
    with open(ref_path, "rb") as f:
        refs = pickle.load(f)
    ref, secs = refs["qudits125"]
    report["qudits125"]["f64"] = open_errors(got_m, ref)
    report["qudits125"]["f64_cpu_seconds"] = secs
    tol = TOL_OPEN["qudits125"]
    (eJ, ef, eg), (fJ, ff, fg) = (report["qudits125"]["plain_short"],
                                  report["qudits125"]["f64"])
    deep = full["qudits125"]["full_depth"]
    phase(26, f"Problem (fused=True and 'auto') on the rho_mid pair at full "
              f"depth, 1 + 1 launches per sweep: {json.dumps(report)}; "
              + "; ".join(f"{k}: fwd / bwd {v['fwd']:.3f} / {v['bwd']:.3f} ms"
                          f" (bound {v['fwd_bound'][0]:.4f} / "
                          f"{v['bwd_bound'][0]:.4f}), clusters "
                          f"{json.dumps(v['fwd_cluster'])} / "
                          f"{json.dumps(v['bwd_cluster'])}, stored "
                          f"{v['stored']}" for k, v in full.items())
              + f"; qudits125 plain fwd / bwd {full['qudits125']['plain_fwd']}"
                f" / {full['qudits125']['plain_bwd']} ms, full depth "
                f"{json.dumps(deep)}; bounds {json.dumps(tol)}; card: {smi}")
    if max(eJ, ef) > tol["J_plain"] or eg > tol["g_plain"] \
            or max(fJ, ff) > tol["J_f64"] or fg > tol["g_f64"] \
            or deep["state"] > TOL_RHO_FULL_STATE_ABS \
            or deep["cbar_rel"] > TOL_RHO_FULL_GRAD_REL \
            or deep["x0bar_rel"] > TOL_RHO_FULL_GRAD_REL:
        raise RuntimeError(f"qudits125 out of bounds: {report['qudits125']}"
                           f", full depth {deep}")

    # the front end on qudits125's physics
    fe_ref = refs["front_end"]
    q32 = Quandary(precision="single", optimizer="device",
                   maxiter=RHO_MID_FE_ITERS, **rho_mid_fe_kwargs())
    s32 = q32._build_setup()
    p32 = q32._problem(s32)
    if p32.fused_form != "rho" or not rho.uses_mid(
            p32.N, p32.model.K, len(p32.engine.Ls_np), 1, p32.ninit):
        raise RuntimeError(f"qudits125's front end (N = {p32.N}) took route "
                           f"{p32.fused_form}, not the mid rho pair")
    p0 = q32._initial_params(s32.oscillators)
    if not np.array_equal(np.asarray(p0), np.asarray(fe_ref["p0"])):
        raise RuntimeError("the front end's initial controls differ from "
                           "the worker's")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        reset_counts()
        t0 = time.perf_counter()
        r32 = q32.simulate(pcof0=p0, datadir=os.path.join(tmp, "sim32"))
        torch.cuda.synchronize()
        t_sim = time.perf_counter() - t0
        sim = main_path_launches(RHO_MID[:1])
        fe_err = front_end_errors(r32, fe_ref["result"])
        reset_counts()
        t0 = time.perf_counter()
        q32.optimize(pcof0=p0, datadir=os.path.join(tmp, "opt32"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        opt = main_path_launches(RHO_MID)
    cost = q32.optim_hist["Cost"]
    niter = len(q32.optim_hist["Iters"]) - 1
    sweeps = device_sweeps(niter)
    fe = dict(N=p32.N, B=p32.ninit, K=p32.model.K, J=len(p32.engine.Ls_np),
              nsteps=q32.nsteps, linsolver=p32.linsolver,
              iters=p32._plan.iters, simulate_s=t_sim,
              simulate_f64_cpu_s=fe_ref["seconds"], errors=fe_err,
              iterations=niter, cost_first=cost[0], cost_last=cost[-1],
              optimize_s=wall, launches_simulate=sim, launches_optimize=opt,
              shapes=dict(rho_mid.mid_layouts))
    phase(26, f"Quandary(precision='single') on qudits125's physics, T = "
              f"{RHO_MID_FE_T} ns: {json.dumps(fe)}; bounds infidelity "
              f"{TOL_RHO_MID_FE_INFID}, trajectories {TOL_RHO_MID_FE_TRAJ}; "
              f"card: {smi}")
    if fe_err["infidelity"] > TOL_RHO_MID_FE_INFID \
            or fe_err["energy"] > TOL_RHO_MID_FE_TRAJ \
            or fe_err["population"] > TOL_RHO_MID_FE_TRAJ \
            or sim[RHO_MID[0]] != 1 or sim[RHO_MID[1]] != 0 \
            or opt[RHO_MID[0]] != sweeps or opt[RHO_MID[1]] != sweeps:
        raise RuntimeError(f"qudits125 front end: errors {fe_err}, launches "
                           f"{sim} / {opt} ({sweeps} sweeps)")
    return dict(worst=worst, full=full, report=report, launches=launches,
                fe=fe, bits=bits, wide=wide)


# Phase 27, the mid-size streamed-plane pair (csrc/stream_mid.cu): the
# 'stream', 'chunk' and dense members past one thread block. Kernel checks
# against the plain version on the card at SMID_NT steps on random
# non-Hermitian stacks of norm about 1 (dt 0.01; scripts/stream_parent.py's
# synthetic cases) at SMID_CHECK's (N, B), 'chunk' and dense also at
# N = 1024 (the reference's 'chunk' range); midsize_bench's N = 256 and 512
# pure through Problem(fused_mode='stream') at full depth; the guarded open
# CNOT on 'stream' (superop, dim 256, 16 basis matrices); 'chunk' through
# Problem on N = 256 at a step where plain Neumann converges; the dense
# forward past one block.
SMID = ("stream_mid_fwd_launches", "stream_mid_bwd_launches")
CMID = ("chunk_mid_fwd_launches", "chunk_mid_bwd_launches")
DMID = ("dense_mid_fwd_launches",)
SMID_SRC = "quandary_tpu_torch/csrc/stream_mid.cu"
SMID_NT = 64            # steps of the checks (the plain version's planes)
SMID_CHECK = ((200, 4), (256, 1), (256, 16), (512, 1))
SMID_SOLVERS = (("neumann", 4), ("jacobi", 4), ("split", 4))
SMID_WIDE = (1024, 1)   # 'chunk' and dense only
# the 'chunk' run: 1000 steps over CHUNK_MID_T ns, dt/2 |d|max = 0.147 on
# midsize_bench's N = 256 (|d|max = 293.6 rad/ns), where 8 Neumann
# iterations leave 0.147^9 = 3e-8 per stage solve
CHUNK_MID_T = 1.0


def smid_synthetic(kind, solver, iters, N, B, E, rng, K=5):
    """scripts/stream_parent.py's synthetic case of the member `kind`: the
    plan, the stack planes, coefficient rows (E, SMID_NT, K) and x0 (B, N)
    on random non-Hermitian stacks of norm about 1, dt 0.01."""
    card = lambda a: torch.as_tensor(np.ascontiguousarray(a), device="cuda",
                                     dtype=torch.float32)
    stack = ((rng.normal(size=(K, N, N)) + 1j * rng.normal(size=(K, N, N)))
             / np.sqrt(N)).astype(np.complex64)
    Sr, Si = card(stack.real), card(stack.imag)
    plan = stream.make_plan(Sr, 0.01, iters,
                            -1j * np.diag(stack[0]).astype(np.complex128),
                            solver, kind=kind)
    C = card(rng.normal(size=(E, SMID_NT, K)) * 0.3)
    x0 = rng.normal(size=(2, B, N))
    return plan, Sr, Si, C, card(x0[0]), card(x0[1])


def smid_same_bits(plan, H, x0r, x0i, rng):
    """Two launches of each mid kernel on the same inputs give the same bits
    (one writer per entry of Hb; the tracks' partials summed in a fixed
    order), and where the plan stores its stage iterates, the backward from
    them gives the bits of the backward that replays them (and both
    forwards the same states)."""
    a = stream_mid._kernel_fwd(plan, *H, x0r, x0i)
    b = stream_mid._kernel_fwd(plan, *H, x0r, x0i)
    same = all((u is None and v is None) or torch.equal(u, v)
               for u, v in zip(a, b))
    w = lambda t: torch.as_tensor(rng.normal(size=tuple(t.shape)),
                                  device="cuda", dtype=torch.float32)
    gT, gh = w(a[0]), w(a[2])
    bw = [stream_mid._kernel_bwd(plan, *H, x0r, x0i, *a[2:], gT, gT, gh, gh)
          for _ in range(2)]
    same = same and all(torch.equal(u, v) for u, v in zip(*bw))
    if plan.store_iters:
        rp = dataclasses.replace(plan, store_iters=False)
        r = stream_mid._kernel_fwd(rp, *H, x0r, x0i)
        rb = stream_mid._kernel_bwd(rp, *H, x0r, x0i, *r[2:], gT, gT, gh, gh)
        same = same and all(torch.equal(u, v) for u, v in zip(a[:4], r[:4]))
        same = same and all(torch.equal(u, v) for u, v in zip(bw[0], rb))
    return same


def smid_sched(plan, H, x0r, x0i, rng, reps=0):
    """The mid backward on both of its schedules (stream.mid_bwd_schedule)
    on the same forward and seeded cotangents: the planner's and the other
    one forced give g0 and Hb in the same bits. With reps, both timed by
    CUDA events in the order chain, helpers, helpers, chain (ms of each
    visit; ratio: helpers over chain)."""
    fwd = stream_mid._kernel_fwd(plan, *H, x0r, x0i)
    w = lambda t: torch.as_tensor(rng.normal(size=tuple(t.shape)),
                                  device="cuda", dtype=torch.float32)
    gT, gh = w(fwd[0]), w(fwd[2])
    args = (plan, *H, x0r, x0i, *fwd[2:], gT, gT, gh, gh)
    got = stream_mid._kernel_bwd(*args)
    mine = dict(stream_mid.mid_layouts["bwd"])
    other = {"helpers": "chain", "chain": "helpers"}[mine["schedule"]]
    alt = stream_mid._kernel_bwd(*args, _schedule=other)
    out = dict(schedule=mine["schedule"], other=other,
               bits=all(torch.equal(a, b) for a, b in zip(got, alt)),
               shapes={mine["schedule"]: mine,
                       other: dict(stream_mid.mid_layouts["bwd"])})
    del got, alt
    if reps:
        runs = {s: (lambda s=s: stream_mid._kernel_bwd(*args, _schedule=s))
                for s in ("chain", "helpers")}
        ms = {s: [] for s in runs}
        for s in ("chain", "helpers", "helpers", "chain"):
            ms[s].append(event_ms(runs[s], reps))
        out.update(ms=ms, ratio=statistics.mean(ms["helpers"])
                   / statistics.mean(ms["chain"]))
    return out


def smid_checks(rng):
    """The mid entry points against the plain version on the card: worst
    errors per member, the layouts and backward schedules driven (the
    planner's against the other one forced, smid_sched) and the bits'
    checks."""
    zero = dict(state=0.0, state_rel=0.0, cbar=0.0, x0bar=0.0, sbar=0.0,
                cbar_rel=0.0, x0bar_rel=0.0, sbar_rel=0.0)
    worst = {"stream": dict(zero), "chunk": dict(zero), "dense": 0.0}
    seen, bits, bad = set(), {}, []
    cases = []
    for N, B in SMID_CHECK:
        for solver, iters in SMID_SOLVERS:
            for store in (True, False):
                cases.append(("stream", solver, iters, N, B, 1, store))
        cases.append(("stream", "split", 4, N, B, 2, True))
        cases.append(("chunk", "neumann", 8, N, B, 1, False))
    cases.append(("chunk", "neumann", 8, 256, 1, 2, False))
    cases.append(("chunk", "neumann", 8, *SMID_WIDE, 1, False))
    # N = 256 basis: 64 chunks of 4 states on 16 tracks of 4 chunks each
    cases.append(("stream", "split", 4, 256, 256, 1, False))
    for kind, solver, iters, N, B, E, store in cases:
        plan, Sr, Si, C, x0r, x0i = smid_synthetic(kind, solver, iters, N, B,
                                                   E, rng)
        plan = dataclasses.replace(plan, store_iters=store)
        if not stream.uses_mid(plan, B, N):
            raise RuntimeError(f"{kind} N = {N}, B = {B} is not past one "
                               "block")
        reset_counts()
        err = stream_compare(plan, Sr, Si, x0r, x0i, C, rng)
        sweep_launches((f"{kind}_mid_fwd_launches",
                        f"{kind}_mid_bwd_launches"))
        lay = stream_mid.mid_layouts
        seen.add(("fwd", lay["fwd"]["layout"]))
        seen.add(("chunks", -(-B // lay["bwd"]["Bc"]) > 1))
        seen.add(("tracks", lay["bwd"]["tracks"] < -(-B // lay["bwd"]["Bc"])))
        key = (f"{kind}_{solver}{iters}_N{N}_B{B}_E{E}_"
               f"{'stored' if store else 'replayed'}")
        shapes = dict(fwd=lay["fwd"], bwd=lay["bwd"])
        with torch.no_grad():
            H = [h.contiguous() for h in stream.planes(plan, Sr, Si, C)]
        sched = smid_sched(plan, H, x0r, x0i, rng)
        bits[f"{key} schedules"] = sched["bits"]
        seen.add(("bwd", sched["shapes"]["chain"]["layout"], store))
        for s, v in sched["shapes"].items():
            seen.add(("bwd_schedule", s, v["layout"]))
        shapes["bwd_other"] = sched["shapes"][sched["other"]]
        print(f"  {key}: {json.dumps(dict(err, **shapes))}", flush=True)
        for k in worst[kind]:
            worst[kind][k] = max(worst[kind][k], err[k])
        if err["state_rel"] > TOL_STATE_REL or max(
                err["cbar_rel"], err["x0bar_rel"],
                err["sbar_rel"]) > TOL_GRAD_REL:
            bad.append(key)
        if kind == "stream" and E == 1 and store and solver != "neumann" \
                and B < 256:
            bits[key] = smid_same_bits(plan, H, x0r, x0i, rng)
        del H
    for N, B in SMID_CHECK + (SMID_WIDE,):
        plan, Sr, Si, C, x0r, x0i = smid_synthetic("dense", "neumann", 8, N,
                                                   B, 1, rng)
        with torch.no_grad():
            H = [h.contiguous() for h in stream.planes(plan, Sr, Si, C)]
            reset_counts()
            xd = torch.cat(dense.dense_propagate(plan, *H, x0r, x0i))
            sweep_launches(DMID)
            hp = stream.plain_forward(plan, *H, x0r, x0i)
            err = float((xd - torch.cat([hp[0][:, -1], hp[1][:, -1]])
                         ).abs().max())
        seen.add(("dense", stream_mid.mid_layouts["fwd"]["layout"]))
        worst["dense"] = max(worst["dense"], err)
        if err > TOL_STATE_ABS:
            bad.append(f"dense_N{N}")
        del H, hp
    return worst, seen, bits, bad


# the forward's band layouts held to the bits of the planner's launch (the
# same products whatever slot or array a row lies in): two slots, one and a
# partial second, resident rows and L2; N % 4 != 0 (rows by cp.async), a
# partial chunk of states, dense
SMID_FWD_LAYOUT_CASES = (("stream", "split", 4, 256, 1, 1, True),
                         ("stream", "jacobi", 3, 512, 1, 1, True),
                         ("stream", "neumann", 6, 130, 16, 1, True),
                         ("chunk", "neumann", 8, 300, 1, 1, False),
                         ("chunk", "neumann", 8, 1024, 3, 1, False),
                         ("dense", "neumann", 8, 1024, 1, 1, False))
# the 'chunk' forward at N = 1024 through Problem, 300 steps of 0.00025 ns
# (dt/2 |d|max = 0.163; past 341 steps its planes exceed the port's plane
# budget)
CHUNK_WIDE_NT, CHUNK_WIDE_DT = 300, 0.00025


def smid_fwd_layout_bits(rng):
    """The mid forward in every band layout and band-row count that fits
    each SMID_FWD_LAYOUT_CASES case at the planner's G: xT, history and
    stored iterates in the bits of the planner's launch. Returns ({case:
    bits equal}, {case: the (layout, rows) driven})."""
    bits, driven = {}, {}
    for kind, solver, iters, N, B, E, store in SMID_FWD_LAYOUT_CASES:
        plan, Sr, Si, C, x0r, x0i = smid_synthetic(kind, solver, iters, N, B,
                                                   E, rng)
        plan = dataclasses.replace(plan, store_iters=store)
        key = f"{kind}_{solver}{iters}_N{N}_B{B}"
        with torch.no_grad():
            H = [h.contiguous() for h in stream.planes(plan, Sr, Si, C)]
        ref = stream_mid._kernel_fwd(plan, *H, x0r, x0i)
        G = stream_mid.mid_layouts["fwd"]["G"]
        R, ok, seen = -(-N // G), True, []
        for layout in stream.MID_SLOTS:
            for rows in sorted({0, R // 2, R - 1, R}) + [None]:
                try:
                    out = stream_mid._kernel_fwd(plan, *H, x0r, x0i,
                                                 _layout=layout, _rows=rows)
                except NotImplementedError:
                    continue
                lay = stream_mid.mid_layouts["fwd"]
                seen.append(f"{layout}/{lay['rows']}")
                ok = ok and lay["G"] == G and all(
                    (a is None and b is None) or torch.equal(a, b)
                    for a, b in zip(out, ref))
        bits[key], driven[key] = ok, seen
        del H, ref
    return bits, driven


def chunk_wide_fwd(to_card):
    """The 'chunk' forward at N = 1024 (midsize_bench's [32, 32] pure, B =
    1, CHUNK_WIDE_NT steps of CHUNK_WIDE_DT): CUDA-event ms (3 reps), its
    bound, one plain run, xT and history against plain (x max) and the
    launch shape."""
    pw = Problem(dataclasses.replace(midsize_closed_setup(
        1024, "pure", ntime=CHUNK_WIDE_NT, T=CHUNK_WIDE_DT * CHUNK_WIDE_NT,
        linsolver="neumann", iters=8), fused_mode="chunk"))
    if not (pw.fused_form == "chunk" and pw.fused_ok
            and stream.uses_mid(pw._plan, pw.ninit, pw.N)):
        raise RuntimeError(f"chunk N = 1024: {pw.fused_refusal}")
    P = to_card(bench_params(pw.setup.nparams))[None]
    with torch.no_grad():
        H = [h.contiguous() for h in stream.planes(
            pw._plan, pw._Sr, pw._Si,
            pw.coeff_rows_mid(P)[..., 0, :].contiguous())]
        got = stream_mid._kernel_fwd(pw._plan, *H, pw._x0r, pw._x0i)
        shape = dict(stream_mid.mid_layouts["fwd"])
        ms = event_ms(lambda: stream_mid._kernel_fwd(
            pw._plan, *H, pw._x0r, pw._x0i), 3)
        plain_ms = event_ms(lambda: stream.plain_forward(
            pw._plan, *H, pw._x0r, pw._x0i), 1, warm=False)
        hr, hi = stream.plain_forward(pw._plan, *H, pw._x0r, pw._x0i)
        err = max(max_rel(got[0], hr[:, -1]), max_rel(got[1], hi[:, -1]),
                  max_rel(got[2], hr), max_rel(got[3], hi))
    del H, got, hr, hi
    return dict(N=pw.N, B=pw.ninit, ntime=CHUNK_WIDE_NT, ms=ms,
                bound=work_bound(pw._plan, 1, CHUNK_WIDE_NT, pw.ninit, pw.N,
                                 False), plain_ms=plain_ms, state_rel=err,
                shape=shape)


def smid_tracks_check(rng):
    """The mid backward with its chunks of states run in turn on fewer
    tracks than chunks: N = 256, 16 states (4 chunks of 4), E = 2, split-4
    stored, at 1, 2 and the planner's tracks. Each against the plain
    backward (x0 and plane cotangents, x max) and against itself on a
    repeat (the same bits). Returns (worst error, bits equal, tracks)."""
    plan, Sr, Si, C, x0r, x0i = smid_synthetic("stream", "split", 4, 256,
                                               16, 2, rng)
    with torch.no_grad():
        H = [h.contiguous() for h in stream.planes(plan, Sr, Si, C)]
        fwd = stream_mid._kernel_fwd(plan, *H, x0r, x0i)
        w = lambda t: torch.as_tensor(rng.normal(size=tuple(t.shape)),
                                      device="cuda", dtype=torch.float32)
        gT, gh = w(fwd[0]), w(fwd[2])
        ref = stream.plain_backward(plan, *H, x0r, x0i, fwd[2], fwd[3], gT,
                                    gT, gh, gh)
        worst, same, tracks = 0.0, True, []
        for t in (1, 2, None):
            runs = [stream_mid._kernel_bwd(plan, *H, x0r, x0i, *fwd[2:], gT,
                                           gT, gh, gh, _tracks=t)
                    for _ in range(2)]
            tracks.append(stream_mid.mid_layouts["bwd"]["tracks"])
            same = same and all(torch.equal(u, v) for u, v in zip(*runs))
            worst = max([worst] + [max_rel(u, v)
                                   for u, v in zip(runs[0], ref)])
    del H, fwd, ref, runs
    return worst, same, tracks


def stream_mid_phase(smi, build, open16):
    """Phase 27: the mid stream pair against plain, its layouts and bits,
    Problem through it at full width on 'stream' (closed and open) and
    'chunk', and the dense forward past one block. open16: phase 14's rho
    route (J, fidelity, grad) of open configuration 2 at full depth and its
    f64 reference at NT_F64 steps."""
    path, secs, log = build
    phase(27, f"built {path} in {secs:.2f} s; "
              + " | ".join(ptxas_lines(log)))
    missing = [f"{k}<{bc}{h}>" for bc in (1, 2, 4, 8)
               for k, h in (("stream_mid_fwd", ", true"),
                            ("stream_mid_fwd", ", false"),
                            ("stream_mid_bwd", ""),
                            ("stream_mid_bwd_helpers", ""))
               if (f"{k}ILi{bc}ELb{int(h == ', true')}E" if h else
                   f"{k}ILi{bc}E") not in log]
    if secs > 0 and missing:
        raise RuntimeError(f"ptxas reported no {missing}")
    rng = np.random.default_rng(27)
    to_card = lambda a: torch.as_tensor(a, device="cuda", dtype=torch.float32)
    worst, seen, bits, bad = smid_checks(rng)
    tr_err, tr_bits, tracks = smid_tracks_check(rng)
    if tr_err > TOL_GRAD_REL:
        bad.append(f"tracks {tracks}")
    bits[f"tracks {tracks}"] = tr_bits
    want = {("fwd", "smem2"), ("fwd", "smem1"), ("fwd", "global"),
            ("bwd", "smem2", True), ("bwd", "smem2", False),
            ("bwd", "smem1", True), ("bwd", "global", False),
            ("bwd_schedule", "helpers", "smem"),
            ("bwd_schedule", "helpers", "global"),
            ("bwd_schedule", "chain", "smem2"),
            ("bwd_schedule", "chain", "global"),
            ("chunks", True), ("tracks", True), ("dense", "global")}
    phase(27, f"mid stream pair == plain at {SMID_NT} steps within "
              f"{TOL_STATE_REL} x max (states; dense abs {TOL_STATE_ABS}), "
              f"{TOL_GRAD_REL} x max (x0, coefficient and stack "
              f"cotangents; the backward on the planner's schedule): worst "
              f"{json.dumps(worst)}; chunks on tracks {tracks}: "
              f"{tr_err:.3g} x max; out of bounds {bad}; layouts and "
              f"backward schedules {sorted(map(str, seen))}; missing "
              f"{sorted(map(str, want - seen))}; same bits on repeat, "
              f"stored against replayed and the other backward schedule "
              f"forced {json.dumps(bits)}")
    if bad or want - seen or not all(bits.values()):
        raise RuntimeError(f"mid stream pair: out of bounds {bad}, layouts "
                           f"not driven {want - seen}, bits {bits}")

    # Problem(fused_mode='stream'), fused=True and 'auto', at full width
    launches = {k: 0 for k in SMID + CMID + DMID}
    full = {}
    for name, N in (("n256_pure", 256), ("n512_pure", 512)):
        mk = lambda fused=True, N=N: dataclasses.replace(
            midsize_closed_setup(N, "pure", fused=fused), fused_mode="stream")
        ps, pa = Problem(mk()), Problem(mk("auto"))
        if not (ps.fused_form == pa.fused_form == "stream" and ps.fused_ok
                and pa.use_fused
                and stream.uses_mid(ps._plan, ps.ninit, ps.N)):
            raise RuntimeError(f"{name}: fused=True / 'auto' did not take "
                               f"the mid stream pair: {ps.fused_refusal}")
        x = bench_params(ps.setup.nparams)
        vg = ps.build_value_and_grad()
        reset_counts()
        (J, aux), g = vg(x, x)
        torch.cuda.synchronize()
        for k, v in sweep_launches(SMID).items():
            launches[k] = launches.get(k, 0) + v
        if not (torch.isfinite(J) and bool(torch.isfinite(g).all())):
            raise RuntimeError(f"{name}: non-finite value_and_grad")
        (Ja, _), ga = pa.build_value_and_grad()(x, x)
        if float(Ja) != float(J) or not torch.equal(ga, g):
            raise RuntimeError(f"{name}: fused='auto' and True differ")
        del pa
        (Jk, _), gk = Problem(midsize_closed_setup(N, "pure")) \
            .build_value_and_grad()(x, x)
        routes = dict(J=abs(float(J) - float(Jk)) / abs(float(Jk)),
                      g=max_rel(g.double(), gk.double()))
        pcut = Problem(dataclasses.replace(mk(), ntime=SMID_NT))
        (Jc, _), gc = pcut.build_value_and_grad()(x, x)
        with plain_on_card():
            (Jp, _), gp = pcut.build_value_and_grad()(x, x)
        plain = dict(J=abs(float(Jc) - float(Jp)) / abs(float(Jp)),
                     g=max_rel(gc.double(), gp.double()))
        del pcut
        rate = 1.0 / median_seconds(lambda: vg(x, x), reps=3)
        with torch.no_grad():
            H = [h.contiguous() for h in stream.planes(
                ps._plan, ps._Sr, ps._Si,
                ps.coeff_rows_mid(to_card(x))[None, :, 0, :])]
        t = stream_kernel_ms(ps._plan, *H, ps._x0r, ps._x0i, 3, True)
        t.update({f"{k}_shape": dict(stream_mid.mid_layouts[k])
                  for k in ("fwd", "bwd")})
        t["schedules"] = smid_sched(ps._plan, H, ps._x0r, ps._x0i,
                                    np.random.default_rng(28), 1)
        del H
        full[name] = dict(t, sweeps_per_s=rate, J=float(J),
                          fidelity=float(aux["fidelity"]), routes=routes,
                          plain=plain, stored=ps._plan.store_iters, N=ps.N,
                          B=ps.ninit, ntime=ps.setup.ntime)
        print(f"  {name}: {json.dumps(full[name])}", flush=True)
        if routes["J"] > TOL_J_PLAIN or routes["g"] > TOL_G_PLAIN \
                or plain["J"] > TOL_J_PLAIN or plain["g"] > TOL_G_PLAIN:
            raise RuntimeError(f"{name} 'stream' against the mid streamK "
                               f"route {routes}, against plain {plain}")
        sch = t["schedules"]
        if t["bwd_shape"]["schedule"] != "helpers" or not sch["bits"]:
            raise RuntimeError(f"{name}: backward on "
                               f"{t['bwd_shape']['schedule']}, not 'helpers',"
                               f" or its schedules differ in bits: {sch}")
    phase(27, f"Problem(fused_mode='stream') (fused=True and 'auto') on "
              f"the mid stream pair at full width, 1 + 1 launches per sweep, "
              f"J / gradient against the mid streamK route (full depth) and "
              f"plain ({SMID_NT} steps) within {TOL_J_PLAIN} / "
              f"{TOL_G_PLAIN}: "
              + "; ".join(f"{k}: {v['sweeps_per_s']:.3f} sweeps/s, fwd / "
                          f"bwd {v['fwd']:.3f} / {v['bwd']:.3f} ms (bound "
                          f"{v['fwd_bound'][0]:.4f} / {v['bwd_bound'][0]:.4f}"
                          f"; plain {v['plain_fwd']:.1f} / "
                          f"{v['plain_bwd']:.1f}), G / Bc / layout fwd "
                          f"{v['fwd_shape']['G']} / {v['fwd_shape']['Bc']} / "
                          f"{v['fwd_shape']['layout']} bwd "
                          f"{v['bwd_shape']['G']} / {v['bwd_shape']['Bc']} / "
                          f"{v['bwd_shape']['layout']} on "
                          f"{v['bwd_shape']['schedule']} + "
                          f"{v['bwd_shape']['helpers']} helpers, backward "
                          f"'helpers' / 'chain' interleaved "
                          f"{json.dumps(v['schedules']['ms'])} (ratio "
                          f"{v['schedules']['ratio']:.3f}, same bits "
                          f"{v['schedules']['bits']}), routes "
                          f"{json.dumps(v['routes'])}, plain "
                          f"{json.dumps(v['plain'])}"
                          for k, v in full.items()) + f"; card: {smi}")

    # the guarded open CNOT on 'stream': superop at dim 256
    p16 = Problem(dataclasses.replace(open_cnot_setup(True),
                                      fused_mode="stream"))
    dim = p16._Sr.shape[-1]
    if not (p16.fused_form == "superop" and p16.fused_ok
            and stream.uses_mid(p16._plan, p16.ninit, dim)):
        raise RuntimeError(f"open configuration 2 on 'stream': route "
                           f"{p16.fused_form}, {p16.fused_refusal}")
    P = to_card(bench_params(p16.setup.nparams))[None]
    reset_counts()
    t0 = time.perf_counter()
    got = open_vg(p16, P)
    torch.cuda.synchronize()
    wall16 = time.perf_counter() - t0
    launches_open = sweep_launches(SMID)
    for k, v in launches_open.items():
        launches[k] = launches.get(k, 0) + v
    got_m = open_vg(Problem(dataclasses.replace(
        open_cnot_setup(True, ntime=NT_F64), fused_mode="stream")), P)
    rho16, ref16 = open16
    eJ, ef, eg = open_errors(got, rho16)
    fJ, ff, fg = open_errors(got_m, ref16)
    tol = TOL_OPEN["cnot16"]
    with torch.no_grad():
        H16 = [h.contiguous() for h in stream.planes(
            p16._plan, p16._Sr, p16._Si,
            p16.coeff_rows_mid(P)[..., 0, :].contiguous())]
    sched16 = smid_sched(p16._plan, H16, p16._x0r, p16._x0i,
                         np.random.default_rng(29), 1)
    del H16
    open_rep = dict(N=p16.N, dim=dim, B=p16.ninit,
                    ntime=p16.setup.ntime, J=float(got[0][0]),
                    schedules=sched16,
                    rho_route=dict(J=eJ, fidelity=ef, grad=eg),
                    f64=dict(J=fJ, fidelity=ff, grad=fg), sweep_s=wall16,
                    launches=launches_open,
                    shapes=dict(stream_mid.mid_layouts))
    phase(27, f"open configuration 2 (N = 16, 16 basis matrices, ntime "
              f"{p16.setup.ntime}) on 'stream', superop at dim {dim} past one "
              f"block: {json.dumps(open_rep)}; bounds rho route "
              f"{TOL_ROUTES_J} / {TOL_ROUTES_G}, f64 at {NT_F64} steps "
              f"{tol['J_f64']} / {tol['g_f64']}")
    if eJ > TOL_ROUTES_J or eg > TOL_ROUTES_G or fJ > tol["J_f64"] \
            or ff > tol["J_f64"] or fg > tol["g_f64"] \
            or sched16["schedule"] != "chain" or not sched16["bits"]:
        raise RuntimeError(f"open 'stream' past one block: {open_rep}")

    # fused_mode='chunk' through Problem, where plain Neumann converges
    pc = Problem(dataclasses.replace(
        midsize_closed_setup(256, "pure", T=CHUNK_MID_T, linsolver="neumann",
                             iters=8), fused_mode="chunk"))
    u = 0.5 * pc.setup.dt * float(np.abs(np.diagonal(
        pc.engine.stack_np[0])).max())
    if not (pc.fused_form == "chunk" and pc.linsolver == "neumann"
            and pc.fused_ok and stream.uses_mid(pc._plan, pc.ninit, pc.N)):
        raise RuntimeError(f"chunk route {pc.fused_form}, {pc.linsolver}, "
                           f"{pc.fused_refusal}")
    x = bench_params(pc.setup.nparams)
    reset_counts()
    (Jc, _), gc = pc.build_value_and_grad()(x, x)
    torch.cuda.synchronize()
    launches_c = sweep_launches(CMID)
    for k, v in launches_c.items():
        launches[k] = launches.get(k, 0) + v
    with plain_on_card():
        (Jcp, _), gcp = pc.build_value_and_grad()(x, x)
    err_c = dict(J=abs(float(Jc) - float(Jcp)) / abs(float(Jcp)),
                 g=max_rel(gc.double(), gcp.double()))
    Cc = pc.coeff_rows_mid(to_card(x))[:, 0, :]
    with torch.no_grad():
        Hc = [h.contiguous() for h in stream.planes(pc._plan, pc._Sr, pc._Si,
                                                    Cc[None])]
    t_c = stream_kernel_ms(pc._plan, *Hc, pc._x0r, pc._x0i, 3, True)
    t_c.update({f"{k}_shape": dict(stream_mid.mid_layouts[k])
                for k in ("fwd", "bwd")})
    t_c["schedules"] = smid_sched(pc._plan, Hc, pc._x0r, pc._x0i,
                                  np.random.default_rng(30), 1)
    rate_c = 1.0 / median_seconds(lambda: pc.build_value_and_grad()(x, x),
                                  reps=3)
    # the dense forward past one block, through pallas_propagate_dense
    reset_counts()
    xd = dense.pallas_propagate_dense(pc.engine.stack_np, Cc,
                                      torch.complex(pc._x0r, pc._x0i),
                                      pc.setup.dt, 8)
    torch.cuda.synchronize()
    launches_d = sweep_launches(DMID)
    for k, v in launches_d.items():
        launches[k] = launches.get(k, 0) + v
    with torch.no_grad():
        xc = stream._kernel_fwd(pc._plan, *Hc, pc._x0r, pc._x0i)[:2]
    err_d = float((xd - torch.complex(*xc)[0]).abs().max())
    dplan = stream.make_plan(pc._Sr, pc.setup.dt, 8, kind="dense")
    t_d = stream_kernel_ms(dplan, *Hc, pc._x0r, pc._x0i, 3, False)
    t_d["plain_fwd"] = t_c["plain_fwd"]     # plain_forward on these planes
    t_d["fwd_shape"] = dict(stream_mid.mid_layouts["fwd"])
    del Hc
    chunk_rep = dict(N=pc.N, ntime=pc.setup.ntime, dt=pc.setup.dt,
                     dt2_dmax=u, J=float(Jc), plain=err_c,
                     sweeps_per_s=rate_c, launches=launches_c, ms=t_c,
                     dense=dict(ms=t_d, launches=launches_d,
                                xT_against_chunk=err_d))
    phase(27, f"fused_mode='chunk' on N = 256 pure, {pc.setup.ntime} steps "
              f"of dt {pc.setup.dt} (dt/2 |d|max = {u:.4f}), plain Neumann-8:"
              f" {json.dumps(chunk_rep)}; card: {smi}")
    if err_c["J"] > TOL_J_PLAIN or err_c["g"] > TOL_G_PLAIN \
            or err_d > TOL_STATE_ABS or t_c["bwd_shape"]["schedule"] != \
            "helpers" or not t_c["schedules"]["bits"]:
        raise RuntimeError(f"chunk route past one block: {err_c}, dense xT "
                           f"{err_d}, backward {t_c['bwd_shape']}, "
                           f"schedules {t_c['schedules']}")
    # the forward's band layouts in bits, and 'chunk' at N = 1024
    lay_bits, lay_driven = smid_fwd_layout_bits(np.random.default_rng(31))
    wide = chunk_wide_fwd(to_card)
    phase(27, f"the mid forward in every band layout and band-row count "
              f"that fits, against the planner's launch: same bits "
              f"{json.dumps(lay_bits)}, driven {json.dumps(lay_driven)}; "
              f"'chunk' N = 1024, {CHUNK_WIDE_NT} steps: "
              f"{json.dumps(wide)}; card: {smi}")
    if not all(lay_bits.values()) or wide["state_rel"] > TOL_STATE_REL:
        raise RuntimeError(f"mid forward layouts' bits {lay_bits}, 'chunk' "
                           f"N = 1024 against plain {wide['state_rel']}")
    return dict(worst=worst, full=full, launches=launches, open=open_rep,
                chunk=t_c, dense=t_d, chunk_rep=chunk_rep,
                fwd_layout_bits=lay_bits, chunk1024=wide)


# Phase 28, the end of queue B: per-sample stacks on the mid streamK pair
# (csrc/streamk_mid.cu reading each candidate's stack and solver rows at a
# stride), the open superop route on 'streamk' past one thread block, and
# the packed robust objective of open systems.
MIDP = ("streamk_mid_packed_fwd_launches", "streamk_mid_packed_bwd_launches")
PB_NT = 64              # steps of the per-block checks against plain
PB_CHECK = ((64, 8, 2), (64, 3, 3), (200, 4, 2), (200, 1, 3))   # N, B, S
PB_SOLVERS = (("split", 3), ("jacobi", 4), ("neumann", 4))
S_OPEN_ROBUST = 8       # open 1's detuned realizations: S * dim = 128
SWAP02_OPEN_NT = 400    # steps of the open three-qubit ensemble (T = 6 ns)
SWAP02_PB_NT = 1000     # steps of the closed SWAP02 ensemble (T = 100 ns)
# The open three-qubit ensemble packed (superop, mid pair) against its
# samples' own route (rho kernels), both f32, on an H100 80GB HBM3 (700 W):
# J 9.3e-8, gradient 2.8e-6 x max. Both routes drift 8.5e-6 x max off the
# complex128 port on the CPU (plain f32 on the CPU: the same 8.5e-6 on
# either route, 1.4e-7 apart), so their orders of summation part them
# further than on open configuration 2 (TOL_ROUTES_G, measured 1.7e-7).
TOL_OPEN8_ROUTES_J, TOL_OPEN8_ROUTES_G = 1e-6, 1.5e-5


def pb_synthetic(N, B, S, solver, iters, store, seed, K=5):
    """A packed plan past one block on the card: S random non-Hermitian
    (K, N, N) stacks (spectral scale O(1), a stiff diagonal) and their
    solver rows, unit-norm x0 (B, N) and coefficient rows (S, PB_NT, Ke)."""
    rng = np.random.default_rng(seed)
    stack = (rng.normal(size=(S, K, N, N))
             + 1j * rng.normal(size=(S, K, N, N))) / np.sqrt(N)
    for a in stack:
        a[0] += np.diag(rng.normal(size=N) * 5.0)
    card = lambda a: torch.as_tensor(np.ascontiguousarray(a), device="cuda",
                                     dtype=torch.float32)
    plan = streamk.make_plan(
        card(stack.real), card(stack.imag), 0.02, iters,
        -1j * np.stack([np.diag(a[0]) for a in stack]), solver,
        store_iters=store)
    x0 = rng.normal(size=(B, N)) + 1j * rng.normal(size=(B, N))
    x0 /= np.linalg.norm(x0, axis=1, keepdims=True)
    C = streamk.extend_coeffs(plan, card(rng.normal(size=(S, PB_NT, K))
                                         * 0.5))
    return plan, card(x0.real), card(x0.imag), C


def pb_bits(plans, x0r, x0i, C, seed):
    """Two launches of each mid kernel for each plan (stored and replayed
    iterates) on the same inputs and cotangents: the same bits in all."""
    outs = []
    for plan in plans:
        for _ in range(2):
            a = streamk_mid._kernel_fwd(plan, x0r, x0i, C)
            gh = torch.as_tensor(
                np.random.default_rng(seed).normal(size=tuple(a[2].shape)),
                device="cuda", dtype=torch.float32)
            gT = gh[:, -1].contiguous()
            outs.append(list(a[:4]) + list(streamk_mid._kernel_bwd(
                plan, x0r, x0i, C, *a[2:], gT, gT, gh, gh)))
    return all(torch.equal(u, v) for o in outs[1:]
               for u, v in zip(outs[0], o))


def pb_checks(rng):
    """The mid pair on per-block plans against the plain version at PB_NT
    steps (PB_CHECK x PB_SOLVERS, stored and replayed iterates): the worst
    errors, whether every repeat and both iterate modes gave the same
    bits, and the launch shapes seen."""
    worst = dict(state=0.0, cbar=0.0, x0bar=0.0, cbar_rel=0.0, x0bar_rel=0.0)
    bad, bits, shapes = [], True, set()
    for N, B, S in PB_CHECK:
        for solver, iters in PB_SOLVERS:
            seed = int(rng.integers(1 << 30))
            plans = []
            for store in (True, False):
                plan, x0r, x0i, C = pb_synthetic(N, B, S, solver, iters,
                                                 store, seed)
                if not (plan.per_block and plan.store_iters == store
                        and streamk.uses_mid(plan, B, N)):
                    raise RuntimeError(f"N = {N}, B = {B}, S = {S}: not a "
                                       "per-block plan on the mid pair")
                shell = types.SimpleNamespace(
                    _x0r=x0r, _x0i=x0i,
                    model=types.SimpleNamespace(K=plan.Ke))
                err = compare_plan(plan, shell, C, np.random.default_rng(
                    seed + 1))
                lay = streamk_mid.mid_layouts
                shapes.add((N, B, S, store) + tuple(
                    (lay[k]["G"], lay[k]["Bc"], lay[k]["layout"])
                    for k in ("fwd", "bwd")))
                print(f"  per-block mid N={N} B={B} S={S} {solver}-{iters} "
                      f"stored={store}: {json.dumps(err)}", flush=True)
                for k in worst:
                    worst[k] = max(worst[k], err[k])
                if err["state"] > TOL_STATE_ABS \
                        or err["cbar_rel"] > TOL_GRAD_REL \
                        or err["x0bar_rel"] > TOL_GRAD_REL:
                    bad.append((N, B, S, solver, store, err))
                plans.append(plan)
            bits = bits and pb_bits(plans, x0r, x0i, C, seed + 2)
    return worst, bad, bits, sorted(shapes)


def route_ms(routes, P, reps):
    """CUDA-event ms of each route's kernel pair for the controls P (1, n),
    interleaved: the routes in order, then in reverse. Per route the two
    readings of each direction, their mean and the bounds, and for superop
    on 'streamk' one run of the plain version. routes: name -> Problem on
    'rho', superop on 'streamk' or superop on 'stream'."""
    fns = {}
    for name, pr in routes.items():
        C = pr.coeff_rows_mid(P)[..., 0, :].contiguous()
        if pr.fused_form == "rho":
            fns[name] = functools.partial(rho_kernel_ms, pr._plan, pr._x0r,
                                          pr._x0i, C, reps, plain=False)
        elif pr.setup.fused_mode == "stream":
            with torch.no_grad():
                H = stream.planes(pr._plan, pr._Sr, pr._Si, C)
            fns[name] = functools.partial(stream_kernel_ms, pr._plan, *H,
                                          pr._x0r, pr._x0i, reps, False)
        else:
            fns[name] = functools.partial(
                kernel_ms, pr._plan, pr._x0r, pr._x0i,
                streamk.extend_coeffs(pr._plan, C), reps, 0)
    runs = {k: [] for k in fns}
    for order in (list(fns), list(fns)[::-1]):
        for k in order:
            runs[k].append(fns[k]())
    out = {}
    for k, rs in runs.items():
        out[k] = {d: [r[d] for r in rs] for d in ("fwd", "bwd")}
        for d in ("fwd", "bwd"):
            out[k][f"{d}_mean"] = statistics.mean(out[k][d])
            out[k][f"{d}_bound"] = rs[0][f"{d}_bound"]
        out[k]["sweep_ms"] = out[k]["fwd_mean"] + out[k]["bwd_mean"]
    del fns
    pr = routes.get("superop_streamk")
    if pr is not None:
        C = streamk.extend_coeffs(pr._plan, pr.coeff_rows_mid(P)[..., 0, :])
        plain = kernel_ms(pr._plan, pr._x0r, pr._x0i, C, 1, 1,
                          plain_warm=False)
        out["superop_streamk"].update(plain_fwd=plain["plain_fwd"],
                                      plain_bwd=plain["plain_bwd"])
    return out


def per_block_phase(smi, p16, open16):
    """Phase 28: per-block plans on the mid pair against plain; superop on
    'streamk' past one block through Problem (open 2 at full width, and
    rho_bench's N = 27) against the rho route and 'stream', each route's
    kernels timed interleaved; the open packed robust gradient on one
    block (open 1, S = 8) and on the mid pair (three open qubits, S = 2),
    and the closed SWAP02 ensemble on the mid pair, against per-sample."""
    rng = np.random.default_rng(28)
    to_card = lambda a: torch.as_tensor(a, device="cuda", dtype=torch.float32)
    out = {}

    # ---- per-block plans on the mid pair against plain ----
    worst, bad, bits, shapes = pb_checks(rng)
    out["worst"] = worst
    phase(28, f"per-block mid pair == plain at {PB_NT} steps within abs "
              f"{TOL_STATE_ABS} (states), {TOL_GRAD_REL} x max (cotangents):"
              f" worst {json.dumps(worst)}; same bits on a repeat and "
              f"between stored and replayed iterates: {bits}; shapes (N, "
              f"B, S, stored, (G, Bc, layout) fwd, bwd) {json.dumps(shapes)}")
    if bad or not bits:
        raise RuntimeError(f"per-block mid pair: {bad}; bits {bits}")

    # ---- superop on 'streamk' past one block: open configuration 2 ----
    ps = Problem(open_cnot_setup(True, fused_rho="superop"))
    dim = ps._Sr.shape[-1]
    if not (ps.fused_form == "superop" and ps.fused_ok
            and streamk.uses_mid(ps._plan, ps.ninit, dim)):
        raise RuntimeError(f"open configuration 2 forced to superop: route "
                           f"{ps.fused_form}, {ps.fused_refusal}")
    P = to_card(bench_params(ps.setup.nparams))[None]
    reset_counts()
    t0 = time.perf_counter()
    got = open_vg(ps, P)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches_sup = sweep_launches(MID)
    pst = Problem(dataclasses.replace(open_cnot_setup(True),
                                      fused_mode="stream"))
    got_st = open_vg(pst, P)
    rho16, ref16 = open16
    rep = dict(N=ps.N, dim=dim, B=ps.ninit, ntime=ps.setup.ntime,
               J=float(got[0][0]), sweep_s=wall, launches=launches_sup,
               shapes=dict(streamk_mid.mid_layouts))
    for name, ref in (("rho_route", rho16), ("stream_superop", got_st)):
        eJ, ef, eg = open_errors(got, ref)
        rep[name] = dict(J=eJ, fidelity=ef, grad=eg)
    eJ, ef, eg = open_errors(got_st, rho16)
    rep["stream_against_rho"] = dict(J=eJ, fidelity=ef, grad=eg)
    ms16 = route_ms({"rho": p16, "superop_streamk": ps,
                     "superop_stream": pst}, P, 2)
    rep["route_ms"] = ms16
    rep["fwd_schedules"] = mid_fwd_checks(
        ps._plan, ps._x0r, ps._x0i,
        streamk.extend_coeffs(ps._plan, ps.coeff_rows_mid(P)[..., 0, :]),
        rng)
    out["open2"] = rep
    phase(28, f"open configuration 2 (N = 16, 16 basis matrices, ntime "
              f"{ps.setup.ntime}) forced to superop on 'streamk': dim {dim} "
              f"on the mid pair: {json.dumps(rep)}; bounds against the other "
              f"routes {TOL_ROUTES_J} / {TOL_ROUTES_G}; card: {smi}")
    if any(rep[k]["J"] > TOL_ROUTES_J or rep[k]["fidelity"] > TOL_ROUTES_J
           or rep[k]["grad"] > TOL_ROUTES_G
           for k in ("rho_route", "stream_superop")) \
            or not fwd_schedules_ok(rep["fwd_schedules"], "helpers"):
        raise RuntimeError(f"superop on 'streamk' past one block: {rep}")
    del pst

    # rho_bench's 3 qutrits (N = 27, dim 729, 3 initial conditions, 1000
    # steps): superop on 'streamk' against the rho route
    q_rho = Problem(midsize_setup(27))
    q_sup = Problem(dataclasses.replace(midsize_setup(27),
                                        fused_rho="superop"))
    if not (q_rho.fused_form == "rho" and q_sup.fused_form == "superop"
            and q_sup.fused_ok and streamk.uses_mid(
                q_sup._plan, q_sup.ninit, q_sup._Sr.shape[-1])):
        raise RuntimeError(f"N = 27: routes {q_rho.fused_form}, "
                           f"{q_sup.fused_form}, {q_sup.fused_refusal}")
    P27 = to_card(bench_params(q_rho.setup.nparams))[None]
    reset_counts()
    t0 = time.perf_counter()
    got27 = open_vg(q_sup, P27)
    torch.cuda.synchronize()
    wall27 = time.perf_counter() - t0
    launches27 = sweep_launches(MID)
    eJ, ef, eg = open_errors(got27, open_vg(q_rho, P27))
    rep27 = dict(dim=q_sup._Sr.shape[-1], B=q_sup.ninit,
                 ntime=q_sup.setup.ntime, linsolver=q_sup.linsolver,
                 J=float(got27[0][0]), sweep_s=wall27, launches=launches27,
                 rho_route=dict(J=eJ, fidelity=ef, grad=eg),
                 shapes=dict(streamk_mid.mid_layouts),
                 route_ms=route_ms({"rho": q_rho, "superop_streamk": q_sup},
                                   P27, 1),
                 fwd_schedules=mid_fwd_checks(
                     q_sup._plan, q_sup._x0r, q_sup._x0i,
                     streamk.extend_coeffs(q_sup._plan, q_sup.coeff_rows_mid(
                         P27)[..., 0, :]), rng))
    out["qutrits27"] = rep27
    phase(28, f"rho_bench's N = 27 forced to superop on 'streamk' (dim "
              f"{rep27['dim']}, 3 initial conditions, 1000 steps) against "
              f"the rho route: {json.dumps(rep27)}; card: {smi}")
    if eJ > TOL_ROUTES_J or ef > TOL_ROUTES_J or eg > TOL_ROUTES_G \
            or not fwd_schedules_ok(rep27["fwd_schedules"], "helpers"):
        raise RuntimeError(f"N = 27 superop against rho: {rep27}")
    del q_rho, q_sup

    # ---- the open packed robust gradient ----
    def ensemble(samples, want, tol_J, tol_g, name):
        """The packed robust objective of the samples at the bench's
        controls: one sweep with the counters at 0 before (exactly 1 + 1
        launches of `want`), against build_robust_objective, walls of
        both and the packed kernels' times."""
        w = np.full(len(samples), 1.0 / len(samples))
        obj = robust.build_packed_robust_objective(samples, w)
        per = robust.build_robust_objective(samples, w)
        x = bench_params(samples[0].setup.nparams).astype(np.float32)
        reset_counts()
        Jp, gp, auxp = robust_vg(obj, x, "cuda")
        torch.cuda.synchronize()
        launches = sweep_launches(want)
        J1, g1, _ = robust_vg(per, x, "cuda")
        errs = dict(J=abs(float(Jp) - float(J1)) / abs(float(J1)),
                    grad=max_rel(gp.double().cpu(), g1.double().cpu()))
        walls = dict(packed_s=median_seconds(
            lambda: robust_vg(obj, x, "cuda"), reps=3),
            per_sample_s=median_seconds(lambda: robust_vg(per, x, "cuda"),
                                        reps=3))
        ms = kernel_ms(obj.plan, *obj.x0, obj.coeff_rows(to_card(x)), 3, 1,
                       plain_warm=False)
        p0 = samples[0]
        rep = dict(S=len(samples), N=p0.N, dim=obj.plan.Sr.shape[-1],
                   B=p0.ninit, ntime=p0.setup.ntime, sample_routes=sorted(
                       {p.fused_form for p in samples}),
                   J=float(Jp), worst_fidelity=float(auxp["fidelity"]),
                   launches=launches, per_sample=errs, walls=walls, ms=ms)
        if want == MIDP:
            rep["shapes"] = dict(streamk_mid.mid_layouts)
            rep["fwd_schedules"] = mid_fwd_checks(
                obj.plan, *obj.x0, obj.coeff_rows(to_card(x)), rng)
            if not fwd_schedules_ok(rep["fwd_schedules"], None):
                raise RuntimeError(f"{name}: forward schedules "
                                   f"{rep['fwd_schedules']}")
        phase(28, f"{name}: {json.dumps(rep)}; bounds against per-sample "
                  f"{tol_J} / {tol_g}; card: {smi}")
        if errs["J"] > tol_J or errs["grad"] > tol_g:
            raise RuntimeError(f"{name} against per-sample: {errs}")
        return rep

    det = np.random.default_rng(5).uniform(-0.002, 0.002, (S_OPEN_ROBUST, 2))
    open1 = [Problem(open_cnot_setup(False, freq01=[FREQ01[0] + a,
                                                   FREQ01[1] + b]))
             for a, b in det]
    out["open1_robust"] = ensemble(
        open1, B2, TOL_J_PLAIN, TOL_G_PLAIN,
        f"open configuration 1 (N = 4, 16 basis matrices) with "
        f"{S_OPEN_ROBUST} detuned realizations, packed on one block")
    del open1
    det3 = np.random.default_rng(6).uniform(-0.002, 0.002, (2, 3))
    f3 = [[f + d for f, d in zip(FREQ3, dd)] for dd in det3]
    open3 = [Problem(swap02_setup(ntime=SWAP02_OPEN_NT, freq3=f,
                                  guards=False, lindblad=True)) for f in f3]
    out["open8_robust"] = ensemble(
        open3, MIDP, TOL_OPEN8_ROUTES_J, TOL_OPEN8_ROUTES_G,
        "three open qubits (N = 8, 64 basis matrices, SWAP02, T1 / T2) with "
        "2 detuned realizations, packed on the mid pair (each sample's own "
        "Problem on the rho route)")
    del open3
    closed = [Problem(swap02_setup(ntime=SWAP02_PB_NT, T=100.0, freq3=f))
              for f in f3]
    out["swap02_robust"] = ensemble(
        closed, MIDP, TOL_J_PLAIN, TOL_G_PLAIN,
        "closed SWAP02 (N = 64, 8 basis states) with 2 detuned "
        "realizations, packed on the mid pair")
    return out


# Phase 29, the large-N structured engines (ops/tensor_rhs.py,
# ops/grouped_rhs.py, ops/grouped_lindblad.py) with their adjoints
# (ops/grouped_adjoint.py, ops/reversible.py). The reference computes
# them as XLA products outside any Pallas kernel, so they launch no kernel
# of csrc/: their products are torch.matmul / einsum, in full f32.
LARGE_CFG = os.path.join("scripts", "perf", "nlevels_32_32_32_32.cfg")
LARGE_REMAT_NT = 4      # steps of the 'remat' gradient at 32^4: it keeps
#                         the graph of a step's 20 split iterations
F32_PEAK_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
# Bounds, about 5x the errors measured on an H100 80GB HBM3 (700 W) (J
# relative; gradients x max|g| of the reference; states abs):
TOL_LARGE = dict(
    # 32^4 complex64 against complex128 on the card (measured 1.8e-8 /
    # 5.2e-7); a TF32 product (about 5e-4 relative) would break them
    J_f64=1e-7, g_f64=3e-6,
    # the hand-written grouped adjoint against 'reversible-ad' (the same
    # forward map; 0 / 4.5e-7) and against 'remat' at LARGE_REMAT_NT
    # steps (0 / 1.4e-7)
    J_ad=1e-7, g_ad=2.5e-6, J_remat=1e-7, g_remat=1e-6,
    # the forward sweep's norm drift, ground and level-7 corner (1.8e-7,
    # 4.9e-6)
    drift=2.5e-5,
    # forward xT, tensor engine against grouped (8.3e-9)
    xT_tensor=5e-8,
    # the open N = 1024 sweep: |trace - 1| (9e-7), complex64 against
    # complex128 (4.2e-8 / 6.9e-7), tensor against grouped xT (2.4e-10)
    trace=5e-6, J_open=2.5e-7, g_open=3.5e-6, xT_open=1.5e-9,
    # Quandary at nlevels 6,6,6,6 (N = 1296), the card's complex64
    # against the port's f64 on the CPU (at 50 steps 4.7e-8 / 3.3e-7)
    J_fe=2.5e-7, g_fe=2e-6)


def large_n_fe_kwargs():
    """Quandary's arguments of phase 29(e): four transmons of 2 essential
    and 4 guard levels (N = 1296, the tensor engine), T = 0.5 ns in 10
    steps, |1000> to a random pure target on the essential levels, no
    dpdm term (the reversible adjoint). The depth is cut for time: the
    tensor engine at this size is bound by the host's launches (27 s for
    50 steps, 13 s for 20, on an H100 80GB HBM3 at 700 W)."""
    rng = np.random.default_rng(42)
    tgt = rng.normal(size=16) + 1j * rng.normal(size=16)
    f = [4.1, 4.2, 4.3, 4.4]
    return dict(Ne=[2] * 4, Ng=[4] * 4, freq01=f, rotfreq=f,
                selfkerr=[0.2] * 4, crosskerr=[0.001] * 6, Jkl=[0.001] * 6,
                T=0.5, dT=0.05, gamma_dpdm=0.0,
                initialcondition="pure, 1, 0, 0, 0",
                targetstate=list(tgt / np.linalg.norm(tgt)),
                carrier_frequency=[[0.0, -0.2]] * 4, rand_seed=1234)


def large_n_vg(q):
    """(problem, params, ((J, aux), g)) of a Quandary's gradient at its
    initial parameters, built through its own setup and Problem."""
    st = q._build_setup()
    prob = q._problem(st)
    p0 = np.asarray(q._initial_params(st.oscillators), np.float32)
    return prob, p0, prob.build_value_and_grad()(p0.astype(np.float64),
                                                 p0.astype(np.float64))


def large_n_reference():
    """Phase 29(e)'s reference: the port's f64 value and gradient on the
    CPU, at the card's float32 parameters."""
    q = Quandary(precision="double", device="cpu", **large_n_fe_kwargs())
    t0 = time.perf_counter()
    prob, p0, ((J, aux), g) = large_n_vg(q)
    return dict(J=float(J), g=g.numpy(), engine=type(prob.engine).__name__,
                route=prob.adjoint_route, seconds=time.perf_counter() - t0)


def lindblad_large_setup(dtype, **kw):
    """scripts/perf/lindblad_large_n.py's setup: two 32-level oscillators
    under decay and dephasing (N = 1024, rho of 2^20 entries), 50 steps of
    8 iterations, |10> to |00>."""
    freqs = [4.1, 4.2]
    ntime = 50
    T = ntime * 0.01
    model = build_structured_model(
        nlevels=[32, 32], freq01_ghz=freqs, rotfreq_ghz=freqs,
        selfkerr_ghz=[0.2, 0.2], crosskerr_ghz=[0.001], jkl_ghz=[0.001],
        decay_time=[100.0, 120.0], dephase_time=[50.0, 60.0], lindblad=True)
    oscs = tuple(OscillatorControl(
        segments=(ControlSegment("spline", nsplines=10, tstart=0.0,
                                 tstop=T),),
        carrier_freqs=(0.0, -0.2 * 2 * np.pi)) for _ in range(2))
    return Setup(model=model, nessential=(32, 32), ntime=ntime, dt=0.01,
                 oscillators=oscs,
                 ground_freqs_radns=tuple(2 * np.pi * f for f in freqs),
                 initcond_type="pure", pure_levels=(1, 0),
                 target_type="pure", pure_target_levels=(0, 0),
                 objective_type="Jtrace", dtype=dtype, linsolve_iters=8,
                 **kw)


def grouped_matvec_flops(eng, B):
    """Operations of one apply_planes on B states: 4 left and 4 right
    real products for H_L, H_R and 8 more per cross-JC pair."""
    m1, m2 = eng.m1, eng.m2
    return (1 + len(eng.cross_idx)) * 8 * (m1 * m1 * m2 + m1 * m2 * m2) * B


def timed(fn, reps=1):
    """(last result, walls s) of reps calls, each ending in a synchronize."""
    walls, out = [], None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return out, walls


def no_launches(what):
    """Fails if any kernel of csrc/ launched since reset_counts: the
    structured engines run none."""
    counts = {**streamk.launch_counts(), **streamk_mid.launch_counts(),
              **rho.launch_counts(), **rho_mid.launch_counts(),
              **stream.launch_counts(), **stream_mid.launch_counts()}
    if any(counts.values()):
        raise RuntimeError(f"{what} launched kernels: {counts}")


def vg_rel(J, g, Jr, gr):
    return (abs(float(J) - float(Jr)) / abs(float(Jr)),
            max_rel(g.double().cpu(), torch.as_tensor(gr).double().cpu()))


def large_n_phase(smi, reference):
    """Phase 29: the large-N structured engines at full width. `reference`
    is (e)'s CPU reference (large_n_reference's dict)."""
    if torch.get_float32_matmul_precision() != "highest" \
            or torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("float32 products must be full f32 (matmul "
                           "precision 'highest', no TF32)")
    out = {}
    bad = []

    def check(name, value, tol):
        if not value <= tol:
            bad.append(f"{name} {value:.3e} > {tol:.0e}")

    # ---- (a) the CLI on the repo's 32^4 configuration ----
    with open(LARGE_CFG) as f:
        text = f.read()
    walls, Js = {}, {}
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_",
                                     dir=cuda_build.BUILD_DIR) as tmp:
        for rt in ("simulation", "gradient"):
            d = os.path.join(tmp, rt)
            os.makedirs(d)
            cfg = os.path.join(d, "config.cfg")
            with open(cfg, "w") as f:     # simulation: the file as it stands
                f.write(re.sub(r"^runtype\s*=\s*\w+", f"runtype = {rt}",
                               text, flags=re.M))
            reset_counts()
            argv = sys.argv
            sys.argv = ["quandary_tpu_torch", cfg, "--quiet"]
            t0 = time.perf_counter()
            try:    # what `python -m quandary_tpu_torch config.cfg` runs
                runpy.run_module("quandary_tpu_torch", run_name="__main__",
                                 alter_sys=True)
                code = 0
            except SystemExit as e:
                code = e.code
            finally:
                sys.argv = argv
            torch.cuda.synchronize()
            walls[rt] = time.perf_counter() - t0
            no_launches(f"CLI {rt}")
            if code != 0:
                raise RuntimeError(f"CLI {rt} at 32^4: exit {code}")
            hist = np.loadtxt(os.path.join(d, "data_out",
                                           "optim_history.dat"), ndmin=2)
            Js[rt] = float(hist[0, 1])
            if rt == "gradient":
                g_cli = np.loadtxt(os.path.join(d, "data_out", "grad.dat"))
        setup, spec = setup_from_config(Config.read(cfg), os.path.dirname(cfg))
    prob = Problem(setup)
    eng_name, solver, route = (type(prob.engine).__name__, prob.linsolver,
                               prob.adjoint_route)
    del prob
    if (eng_name, solver, route) != ("GroupedEngine", "split", "grouped") \
            or abs(Js["simulation"] - Js["gradient"]) > 1e-12 \
            or not np.all(np.isfinite(g_cli)):
        raise RuntimeError(f"CLI at 32^4: engine {eng_name}, linsolver "
                           f"{solver}, adjoint {route}, J {Js}")
    out["cli"] = dict(walls=walls, J=Js["simulation"], engine=eng_name,
                      linsolver=solver, adjoint=route)
    phase(29, f"python -m quandary_tpu_torch {LARGE_CFG} (N = "
              f"{setup.model.N}, complex128, {setup.ntime} steps): engine "
              f"{eng_name}, the "
              f"guard's linsolver {solver!r}, adjoint {route!r}; wall s "
              f"{json.dumps({k: round(v, 3) for k, v in walls.items()})}; "
              f"J {Js['simulation']:.12f} (the gradient run's within 1e-12); "
              f"|grad|max {np.abs(g_cli).max():.3e}; card: {smi}")

    # ---- (a') the forward sweep of large_n_bench.py: the real-plane
    # step on the ground and a high corner state, complex64 ----
    s32 = dataclasses.replace(setup, dtype=torch.complex64)
    p32 = Problem(s32)
    eng = p32.engine
    P = torch.as_tensor(spec.params0, device="cuda", dtype=torch.float32)
    with torch.no_grad():
        C = p32.coeff_rows_mid(P)[:, 0, :]
        mk = make_real_split_step if p32.linsolver == "split" \
            else make_real_imr_step
        step = mk(eng, s32.dt, s32.linsolve_iters)
        hi = 7 * 33            # levels (7, 7) in each group
        Xr = torch.zeros((2, eng.m1, eng.m2), device="cuda")
        Xr[0, 0, 0] = 1.0
        Xr[1, hi, hi] = 1.0
        Xi = torch.zeros_like(Xr)

        def sweep():
            xr, xi = Xr, Xi
            for n in range(C.shape[0]):
                xr, xi = step(xr, xi, C[n])
            return xr, xi

        (ar, ai), fw = timed(sweep)
        norms = (ar * ar + ai * ai).sum(dim=(-2, -1)).double().cpu() - 1.0
    nt = s32.ntime
    mv = 1 + s32.linsolve_iters
    fwd_bound = nt * mv * grouped_matvec_flops(eng, 1) / F32_PEAK_FLOPS
    out["fwd"] = dict(walls=fw, ms_per_step=fw[-1] / nt * 1e3,
                      drift_ground=float(norms[0]),
                      drift_level7=float(norms[1]), bound_s_B1=fwd_bound)
    check("norm drift", float(norms.abs().max()), TOL_LARGE["drift"])
    phase(29, f"forward sweep at N = {eng.N}, complex64, real-plane "
              f"{p32.linsolver} step, 2 states: {fw[-1]:.3f} s "
              f"({fw[-1] / nt * 1e3:.2f} ms/step, unwarmed); "
              f"norm drift ground {float(norms[0]):+.2e}, level 7 corner "
              f"{float(norms[1]):+.2e}; bound of one state's forward "
              f"{fwd_bound:.3f} s ({mv} matvecs of "
              f"{grouped_matvec_flops(eng, 1) / 1e9:.1f} GFLOP a step at "
              f"67 TFLOP/s); card: {smi}")

    # ---- (b) the gradient: the hand-written grouped adjoint, against
    # the same Problem in complex128 on the card: (a)'s gradient run ----
    x = np.asarray(spec.params0, np.float64)
    if p32.adjoint_route != "grouped":
        raise RuntimeError(f"32^4 adjoint {p32.adjoint_route}")
    reset_counts()
    vg = p32.build_value_and_grad()
    ((J32, _), g32), gw = timed(lambda: vg(x, x), 3)
    no_launches("the grouped adjoint")
    del p32, vg
    torch.cuda.empty_cache()
    J64, g64 = Js["gradient"], g_cli
    pad = Problem(dataclasses.replace(s32, adjoint="reversible-ad"))
    (Jad, _), gad = pad.build_value_and_grad()(x, x)
    if pad.adjoint_route != "grouped-ad":
        raise RuntimeError(f"reversible-ad route {pad.adjoint_route}")
    del pad
    torch.cuda.empty_cache()
    cut = dataclasses.replace(s32, ntime=LARGE_REMAT_NT)
    (Jc, _), gc = Problem(cut).build_value_and_grad()(x, x)
    prem = Problem(dataclasses.replace(cut, adjoint="remat"))
    (Jr, _), gr = prem.build_value_and_grad()(x, x)
    if prem.adjoint_route != "stored":
        raise RuntimeError(f"remat route {prem.adjoint_route}")
    del prem
    torch.cuda.empty_cache()
    e64 = vg_rel(J32, g32, J64, g64)
    ead = vg_rel(J32, g32, Jad, gad)
    erm = vg_rel(Jc, gc, Jr, gr)
    check("J c64-c128", e64[0], TOL_LARGE["J_f64"])
    check("g c64-c128", e64[1], TOL_LARGE["g_f64"])
    check("J grouped-ad", ead[0], TOL_LARGE["J_ad"])
    check("g grouped-ad", ead[1], TOL_LARGE["g_ad"])
    check("J remat", erm[0], TOL_LARGE["J_remat"])
    check("g remat", erm[1], TOL_LARGE["g_remat"])
    mvb = 1 + 2 * s32.linsolve_iters + 1       # y, the 2B solve, w
    grad_bound = fwd_bound + nt * mvb * grouped_matvec_flops(eng, 1) \
        / F32_PEAK_FLOPS
    out["grad"] = dict(walls=gw, median_s=statistics.median(gw),
                       fwd_bound_s=fwd_bound, sweep_bound_s=grad_bound,
                       err_f64=e64, err_reversible_ad=ead, err_remat=erm,
                       J=float(J32), J64=float(J64))
    phase(29, f"Problem(32^4, complex64).build_value_and_grad(): the "
              f"hand-written grouped adjoint, median wall of 3 "
              f"{statistics.median(gw):.3f} s ({[round(w, 3) for w in gw]}); "
              f"the forward's bound {fwd_bound:.3f} s, the sweep's "
              f"(forward + {mvb} matvecs a reversed step) {grad_bound:.3f} "
              f"s; J {float(J32):.9f}; against complex128 on the card J "
              f"{e64[0]:.2e} g {e64[1]:.2e}, against 'reversible-ad' J "
              f"{ead[0]:.2e} g {ead[1]:.2e}, against 'remat' at "
              f"{LARGE_REMAT_NT} steps J {erm[0]:.2e} g {erm[1]:.2e} (x "
              f"max|g|); card: {smi}")

    # ---- (c) the tensor engine against the grouped one at 32^4 ----
    fwds = {}
    for name in ("tensor", "grouped"):
        pe = Problem(dataclasses.replace(s32, engine=name, linsolver="split"))
        xT, w = timed(lambda: pe.build_propagate_final()(x))
        fwds[name] = (type(pe.engine).__name__, xT, w[0])
        del pe
        torch.cuda.empty_cache()
    dx = float((fwds["tensor"][1] - fwds["grouped"][1]).abs().max())
    check("xT tensor-grouped", dx, TOL_LARGE["xT_tensor"])
    if fwds["tensor"][0] != "TensorEngine":
        raise RuntimeError(f"engine='tensor' built {fwds['tensor'][0]}")
    out["tensor"] = dict(xT_abs=dx, wall_tensor=fwds["tensor"][2],
                         wall_grouped=fwds["grouped"][2])
    phase(29, f"engine='tensor' against 'grouped' at 32^4 (complex64, "
              f"the complex split step, {nt} steps): xT within abs {dx:.2e}; "
              f"forward wall tensor {fwds['tensor'][2]:.3f} s, grouped "
              f"{fwds['grouped'][2]:.3f} s; card: {smi}")
    del fwds

    # ---- (d) open systems: lindblad_large_n.py's N = 1024 ----
    pl = Problem(lindblad_large_setup(torch.complex64))
    if type(pl.engine).__name__ != "GroupedLindbladEngine":
        raise RuntimeError(f"open N = 1024 engine {type(pl.engine)}")
    xo = np.random.default_rng(3).uniform(-1, 1, pl.setup.nparams) * 0.02
    xo = xo.astype(np.float32).astype(np.float64)
    reset_counts()
    xT, ow = timed(lambda: pl.build_propagate_final()(np.zeros_like(xo)))
    tr = float(torch.diagonal(xT[0]).real.sum())
    ((Jo, _), go), ogw = timed(lambda: pl.build_value_and_grad()(xo, xo))
    no_launches("the open N = 1024 sweep")
    solver_o = pl.linsolver
    del pl, xT
    torch.cuda.empty_cache()
    (Jo64, _), go64 = Problem(lindblad_large_setup(
        torch.complex128)).build_value_and_grad()(xo, xo)
    torch.cuda.empty_cache()
    xTs = {}
    for name in ("tensor", "grouped"):
        pe = Problem(lindblad_large_setup(torch.complex64, engine=name,
                                          linsolver=solver_o))
        xTs[name] = pe.build_propagate_final()(xo)
        del pe
    dxo = float((xTs["tensor"] - xTs["grouped"]).abs().max())
    del xTs
    torch.cuda.empty_cache()
    eo = vg_rel(Jo, go, Jo64, go64)
    check("open trace", abs(tr - 1.0), TOL_LARGE["trace"])
    check("open J c64-c128", eo[0], TOL_LARGE["J_open"])
    check("open g c64-c128", eo[1], TOL_LARGE["g_open"])
    check("open xT tensor-grouped", dxo, TOL_LARGE["xT_open"])
    out["open"] = dict(trace=tr, fwd_s=ow[0], grad_walls=ogw, err_f64=eo,
                       xT_tensor_abs=dxo, linsolver=solver_o)
    phase(29, f"open N = 1024 (two 32-level oscillators, rho of 2^20 "
              f"entries, {solver_o}, 8 iterations, 50 steps) on "
              f"GroupedLindbladEngine, complex64: forward {ow[0]:.3f} s, "
              f"trace {tr:.7f}; gradient ('remat': one state a step, the "
              f"step recomputed) walls s {[round(w, 3) for w in ogw]}; "
              f"against complex128 on the card J {eo[0]:.2e} g {eo[1]:.2e} "
              f"(x max|g|); xT against engine='tensor' abs {dxo:.2e}; "
              f"card: {smi}")

    # ---- (e) the front end at N = 1296 against the CPU ----
    q = Quandary(precision="single", **large_n_fe_kwargs())
    reset_counts()
    (pf, _, ((Jf, _), gf)), fw_ = timed(lambda: large_n_vg(q))
    no_launches("Quandary at N = 1296")
    ef = vg_rel(Jf, gf, reference["J"], reference["g"])
    check("Quandary N = 1296 J", ef[0], TOL_LARGE["J_fe"])
    check("Quandary N = 1296 g", ef[1], TOL_LARGE["g_fe"])
    if (type(pf.engine).__name__, pf.adjoint_route) != (
            reference["engine"], reference["route"]):
        raise RuntimeError(f"N = 1296: {type(pf.engine).__name__} "
                           f"{pf.adjoint_route} against {reference}")
    out["front_end"] = dict(err_f64=ef, wall_s=fw_[0],
                            cpu_s=reference["seconds"])
    phase(29, f"Quandary(precision='single') at nlevels 6,6,6,6 (N = 1296, "
              f"{type(pf.engine).__name__}, adjoint {pf.adjoint_route!r}, "
              f"{q.nsteps} steps): gradient wall {fw_[0]:.3f} s (the f64 CPU "
              f"reference {reference['seconds']:.1f} s); against it J "
              f"{ef[0]:.2e} g {ef[1]:.2e} (x max|g|); card: {smi}")
    if bad:
        raise RuntimeError("phase 29 out of bounds: " + "; ".join(bad))
    return out


def large_n_phase_alone():
    """Phase 29 by itself (after a change to the structured engines):
    (e)'s CPU reference here, then large_n_phase."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    return large_n_phase(smi, large_n_reference())


# Phase 30, the time-parallel scan (ops/propagator.py) under 'auto', the
# host-loop runner (ops/hostloop.py) and the Hessian tools
# (optim/hessian.py). The reference computes the scan with XLA products
# outside any Pallas kernel, so its products are torch.matmul in full f32 /
# f64 and (a)-(d) launch no kernel of csrc/ (checked); (e)'s FD Hessian on
# the fused route launches the streamK pair once per gradient.
TP_CUT_NT = 256         # SWAP02's physics against the sequential loop
TP_GRAD_NT = 8192       # its scan gradient: 0.5 GiB a (T, N, N) array
TP_EDGE_NT = 32768      # its scan forward at the budget: 2^27 entries
TP_FD_EPS32 = 1e-2      # eps of the complex64 FD Hessian (section 6)
# Bounds: the scan against the sequential loop in f64, those of
# tests/test_time_parallel.py (J and aux abs; gradient rtol / atol;
# trajectory abs). The rest about 5x the errors measured on an H100 80GB
# HBM3 (700 W), PERF.md slice 25.
TOL_TP = dict(J=1e-10, aux=1e-10, g_rtol=1e-7, g_atol=1e-12, traj=1e-10,
              # SWAP02's complex64 scan against complex128 (J relative,
              # gradient x max; measured 6.0e-7 / 1.8e-6): a TF32 product,
              # about 5e-4 relative, breaks them
              J_c64=3e-6, g_c64=1e-5,
              # |norm - 1| of every state at the budget's edge (4.7e-13)
              norm=2.5e-12,
              # the host-loop runner against the plain route (states abs,
              # gradient relative: tests/test_hostloop.py's; measured 0)
              host_x=1e-12, host_g=1e-8,
              # the AD Hessian: symmetry abs and FD against AD in f64 x
              # max(1, max|H|) (the reference test's; measured 9.0e-17,
              # 2.0e-11); the complex64 FD on the streamK kernels against
              # the f64 AD x max|H| (6.0e-4)
              sym=1e-9, fd=1e-5, fd32=3e-3)


def tp_open_setup(**kw):
    """tests/test_time_parallel.py's open case: two transmons [3, 2] (one
    guard level on the first; N = 6, 36 basis density matrices) with
    T1 / T2, 100 steps, the CNOT, Jtrace with leakage and energy
    penalties, complex128."""
    Ne, nlevels = [2, 2], [3, 2]
    model = build_standard_model(
        nlevels=nlevels, freq01_ghz=[4.8, 5.1], rotfreq_ghz=[4.79, 5.09],
        selfkerr_ghz=[0.22, 0.25], crosskerr_ghz=[0.01], jkl_ghz=[0.005],
        decay_time=[100.0, 80.0], dephase_time=[50.0, 60.0], lindblad=True)
    T, ntime = 20.0, 100
    oscs = tuple(OscillatorControl(
        segments=(ControlSegment("spline", nsplines=6, tstart=0.0,
                                 tstop=T),),
        carrier_freqs=(0.0, 2 * np.pi * 0.05)) for _ in range(2))
    return Setup(
        model=model, nessential=tuple(Ne), ntime=ntime, dt=T / ntime,
        oscillators=oscs, ground_freqs_radns=(2 * np.pi * 4.8,
                                              2 * np.pi * 5.1),
        initcond_type="basis", target_type="gate",
        target_gate_full=gates.assemble_gate(gates.cnot(), nlevels, Ne,
                                             [0.0, 0.0], T),
        objective_type="Jtrace", gamma_tik=1e-4, gamma_penalty=0.1,
        gamma_penalty_energy=0.1, **kw)


def hostloop_setup():
    """tests/test_hostloop.py's problem: two transmons [3, 2], 30 steps,
    Jfrobenius to the ground state, complex128, the sequential loop."""
    T, ntime = 4.0, 30
    model = build_standard_model(
        nlevels=[3, 2], freq01_ghz=[4.1, 5.0], rotfreq_ghz=[4.05, 4.95],
        selfkerr_ghz=[0.2, 0.15], jkl_ghz=[0.01], crosskerr_ghz=[0.002])
    oscs = tuple(OscillatorControl(
        segments=(ControlSegment("spline", nsplines=5, tstart=0.0,
                                 tstop=T),), carrier_freqs=(0.0,))
        for _ in range(2))
    return Setup(
        model=model, nessential=(3, 2), ntime=ntime, dt=T / ntime,
        oscillators=oscs, ground_freqs_radns=(1.0, 1.0),
        initcond_type="basis", target_type="pure", pure_target_levels=(0, 0),
        objective_type="Jfrobenius", time_parallel=False)


def hessian_setup(**kw):
    """tests/test_hessian_sanity.py's problem: one qubit, 12 steps, from
    the ground state to the excited one, Jfrobenius, complex128 unless
    `kw` says otherwise."""
    T, ntime = 2.0, 12
    model = build_standard_model(
        nlevels=[2], freq01_ghz=[4.1], rotfreq_ghz=[4.08],
        selfkerr_ghz=[0.2], crosskerr_ghz=[], jkl_ghz=[])
    osc = OscillatorControl(
        segments=(ControlSegment("spline", nsplines=3, tstart=0.0,
                                 tstop=T),), carrier_freqs=(0.0,))
    return Setup(
        model=model, nessential=(2,), ntime=ntime, dt=T / ntime,
        oscillators=(osc,), ground_freqs_radns=(1.0,),
        initcond_type="pure", pure_levels=(0,), target_type="pure",
        pure_target_levels=(1,), objective_type="Jfrobenius",
        gamma_tik=1e-4, **kw)


def tp_against_sequential(pt, ps, x, name, check):
    """J, every aux term, the gradient and the trajectory of a problem on
    the scan (pt) against the sequential loop (ps), checked against
    TOL_TP's bounds of tests/test_time_parallel.py; returns the errors."""
    if not pt.time_parallel or ps.time_parallel:
        raise RuntimeError(f"{name}: time_parallel {pt.time_parallel} / "
                           f"{ps.time_parallel}, expected True / False")
    (Jt, at), gt = pt.build_value_and_grad()(x, x)
    (Js, as_), gs = ps.build_value_and_grad()(x, x)
    gt, gs = gt.double().cpu(), gs.double().cpu()
    tt = pt.build_propagate_trajectory()(x)
    ts = ps.build_propagate_trajectory()(x)
    err = dict(J=abs(float(Jt) - float(Js)),
               aux=max(abs(float(at[k]) - float(as_[k])) for k in at),
               g_excess=float(((gt - gs).abs() - TOL_TP["g_rtol"]
                               * gs.abs()).max()),
               g_rel=max_rel(gt, gs),
               traj=float((tt - ts).abs().max()))
    check(f"{name} J", err["J"], TOL_TP["J"])
    check(f"{name} aux", err["aux"], TOL_TP["aux"])
    check(f"{name} g (rtol 1e-7)", err["g_excess"], TOL_TP["g_atol"])
    check(f"{name} traj", err["traj"], TOL_TP["traj"])
    return err


def time_parallel_phase(smi):
    """Phase 30: the time-parallel scan on the card against the sequential
    loop, at the budget's edge, in complex64; the host-loop runner; the
    Hessian tools, the FD Hessian also through the streamK kernels."""
    if torch.get_float32_matmul_precision() != "highest" \
            or torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("float32 products must be full f32 (matmul "
                           "precision 'highest', no TF32)")
    out, bad = {}, []

    def check(name, value, tol):
        if not value <= tol:
            bad.append(f"{name} {value:.3e} > {tol:.0e}")

    # ---- (a) config_template.cfg's Problem: 'auto' takes the scan ----
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_",
                                     dir=cuda_build.BUILD_DIR) as tmp:
        setup, spec = setup_from_config(Config.read("config_template.cfg"),
                                        tmp)
    reset_counts()
    pa = Problem(setup)
    ps = Problem(dataclasses.replace(setup, time_parallel=False))
    x = spec.params0
    out["cfg"] = tp_against_sequential(pa, ps, x, "(a)", check)
    walls = {}
    for name, p in (("scan", pa), ("sequential", ps)):
        vg = p.build_value_and_grad()
        walls[name] = timed(lambda: vg(x, x), reps=3)[1]
    out["cfg"]["walls"] = walls
    lb, ub = build_bounds(setup.oscillators, spec.control_bounds)
    res = run_optimization_device(pa, x, lb, ub, chunk=2, maxiter=2,
                                  graph=True, gatol=0.0, grtol=0.0,
                                  fatol=0.0, inftol=0.0, verbose=False)
    torch.cuda.synchronize()
    objs = [h.objective for h in res.history]
    if res.niter != 2 or not np.all(np.isfinite(objs)) \
            or not objs[-1] < objs[0]:
        raise RuntimeError(f"(a) device driver on the scan: niter "
                           f"{res.niter}, J {objs}")
    no_launches("phase 30(a)")
    phase(30, f"config_template.cfg's Problem on the card (complex128, N = "
              f"{pa.N}, B = {pa.ninit}, {setup.ntime} steps, "
              f"{pa.linsolver}-{setup.linsolve_iters}): 'auto' takes the "
              f"scan; against time_parallel=False J {out['cfg']['J']:.2e} "
              f"aux {out['cfg']['aux']:.2e} g {out['cfg']['g_rel']:.2e} x "
              f"max traj {out['cfg']['traj']:.2e}; gradient walls s scan "
              f"{[round(w, 4) for w in walls['scan']]} median "
              f"{statistics.median(walls['scan']):.4f}, sequential "
              f"{[round(w, 4) for w in walls['sequential']]} median "
              f"{statistics.median(walls['sequential']):.4f}; a chunk of 2 "
              f"device iterations with graph=True: J {objs[0]:.6f} -> "
              f"{objs[-1]:.6f}; no kernel launched; card: {smi}")

    # ---- (b) tests/test_time_parallel.py's open case, forced ----
    reset_counts()
    po = Problem(tp_open_setup(time_parallel=True))
    pos = Problem(tp_open_setup(time_parallel=False))
    xo = np.random.default_rng(11).normal(size=po.setup.nparams) * 0.01
    out["open"] = tp_against_sequential(po, pos, xo, "(b)", check)
    no_launches("phase 30(b)")
    phase(30, f"open N = {po.N} (dim {po.N ** 2}, {po.ninit} density "
              f"matrices, {po.setup.ntime} steps), time_parallel=True "
              f"against False on the card: J {out['open']['J']:.2e} aux "
              f"{out['open']['aux']:.2e} g {out['open']['g_rel']:.2e} x max "
              f"traj {out['open']['traj']:.2e}")

    # ---- (c) SWAP02's physics in complex128: the sequential loop at
    # TP_CUT_NT steps, the budget's edge, the gradient at TP_GRAD_NT, and
    # the complex64 scan ----
    def swap(nt, dtype=torch.complex128, **kw):
        return dataclasses.replace(
            swap02_setup(ntime=nt, fused="auto"), dtype=dtype,
            linsolver="jacobi", **kw)

    reset_counts()
    p256 = Problem(swap(TP_CUT_NT))
    rng = np.random.default_rng(30)
    xs = rng.uniform(-1, 1, p256.setup.nparams) * 0.02
    xs = xs.astype(np.float32).astype(np.float64)
    out["swap"] = tp_against_sequential(
        p256, Problem(swap(TP_CUT_NT, time_parallel=False)), xs, "(c)",
        check)
    p32 = Problem(swap(TP_CUT_NT, torch.complex64, fused=False))
    if not p32.time_parallel:
        raise RuntimeError("(c) the complex64 problem is not on the scan")
    (J64, _), g64 = p256.build_value_and_grad()(xs, xs)
    (J32, _), g32 = p32.build_value_and_grad()(xs, xs)
    out["swap"]["J_c64"], out["swap"]["g_c64"] = vg_rel(J32, g32, J64,
                                                        g64.cpu())
    check("(c) complex64 J", out["swap"]["J_c64"], TOL_TP["J_c64"])
    check("(c) complex64 g", out["swap"]["g_c64"], TOL_TP["g_c64"])
    for key, nt in (("edge", TP_EDGE_NT), ("grad", TP_GRAD_NT)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        p = Problem(swap(nt))
        if not p.time_parallel:
            raise RuntimeError(f"(c) ntime {nt} is not on the scan")
        if key == "edge":
            run = p.build_propagate_trajectory()
            traj, w = timed(lambda: run(xs))
            nrm = torch.linalg.vector_norm(traj, dim=-1)
            out["swap"]["norm"] = float((nrm - 1).abs().max())
            check("(c) norms at the edge", out["swap"]["norm"],
                  TOL_TP["norm"])
            if not bool(torch.isfinite(traj).all()):
                bad.append("(c) non-finite states at the edge")
            del traj, nrm
        else:
            vg = p.build_value_and_grad()
            (_, g), w = timed(lambda: vg(xs, xs))
            if not bool(torch.isfinite(g).all()):
                bad.append("(c) non-finite gradient")
        out["swap"][key] = dict(ntime=nt, wall=w[0],
                                peak_gib=torch.cuda.max_memory_allocated()
                                / 2 ** 30)
        del p
    no_launches("phase 30(c)")
    sw = out["swap"]
    phase(30, f"SWAP02's physics (N = {p256.N}, B = {p256.ninit}, complex128,"
              f" {p256.linsolver}-{p256.setup.linsolve_iters}): against the "
              f"sequential loop at {TP_CUT_NT} steps J {sw['J']:.2e} aux "
              f"{sw['aux']:.2e} g {sw['g_rel']:.2e} x max traj "
              f"{sw['traj']:.2e}; complex64 scan against complex128 J "
              f"{sw['J_c64']:.2e} g {sw['g_c64']:.2e} x max; forward at "
              f"ntime {TP_EDGE_NT} (ntime N^2 = "
              f"2^{math.log2(TP_EDGE_NT * p256.N ** 2):.0f}, the budget "
              f"2^{math.log2(p256.setup.time_parallel_budget):.0f}) "
              f"{sw['edge']['wall']:.3f} s, peak "
              f"{sw['edge']['peak_gib']:.2f} GiB, max |norm - 1| "
              f"{sw['norm']:.2e}; gradient at ntime {TP_GRAD_NT} "
              f"{sw['grad']['wall']:.3f} s, peak {sw['grad']['peak_gib']:.2f}"
              f" GiB")

    # ---- (d) the host-loop runner on tests/test_hostloop.py's problem ----
    reset_counts()
    ph = Problem(hostloop_setup())
    xh = np.random.default_rng(1).normal(size=ph.setup.nparams) * 0.02
    runner = HostLoopRunner(ph)
    xT, stored = runner.forward(xh, store_states=True)
    host_x = float((xT - ph.build_propagate_final()(xh)).abs().max())

    def loss(xT, p):
        re, _ = ph._eval_J_parts_real(xT.real, xT.imag)
        return torch.sum(ph._weights * re) + 1e-4 * torch.sum(p * p)

    (Jh, gh), wh = timed(lambda: runner.gradient(xh, loss), reps=2)
    p = ph._param_tensor(xh).requires_grad_(True)
    (g_ad,) = torch.autograd.grad(loss(ph.propagate_final(p), p), p)
    host_g = max_rel(gh.cpu(), g_ad.cpu())
    check("(d) host-loop forward", host_x, TOL_TP["host_x"])
    check("(d) host-loop gradient", host_g, TOL_TP["host_g"])
    no_launches("phase 30(d)")
    out["hostloop"] = dict(x=host_x, g=host_g, wall=wh[-1])
    phase(30, f"HostLoopRunner (N = {ph.N}, {ph.setup.ntime} steps, states "
              f"on the host: {len(stored)} on {stored[0].device}): forward "
              f"against the plain route {host_x:.2e}, gradient against "
              f"autograd {host_g:.2e} x max, gradient walls s "
              f"{[round(w, 3) for w in wh]}")

    # ---- (e) the Hessian tools ----
    reset_counts()
    pe = Problem(hessian_setup())
    xe = (np.random.default_rng(0).normal(size=pe.setup.nparams) * 0.02
          ).astype(np.float32).astype(np.float64)
    (H, Hfd, (w_eig, _)), we = timed(lambda: (
        hessian(pe, xe), fd_hessian(pe, xe, eps=1e-5),
        hessian_eigen(pe, xe)))
    no_launches("phase 30(e) in f64")
    scale = np.abs(H).max()
    sym = float(np.abs(H - H.T).max())
    fd = float(np.abs(H - Hfd).max() / max(1.0, scale))
    check("(e) symmetry", sym, TOL_TP["sym"])
    check("(e) FD against AD", fd, TOL_TP["fd"])
    if not np.all(np.diff(w_eig) >= 0):
        bad.append("(e) eigenvalues not ascending")
    pf = Problem(hessian_setup(dtype=torch.complex64, fused=True))
    if pf.fused_form != "streamk":
        raise RuntimeError(f"(e) fused_form {pf.fused_form}")
    try:
        hessian(pf, xe)
        bad.append("(e) hessian ran on the fused route")
    except NotImplementedError as e:
        if "fused route" not in str(e):
            raise
    reset_counts()
    Hf32, wf = timed(lambda: fd_hessian(pf, xe, eps=TP_FD_EPS32))
    n = pf.setup.nparams
    counts = main_path_launches(["streamk_fwd_launches",
                                 "streamk_bwd_launches"])
    if (counts["streamk_fwd_launches"], counts["streamk_bwd_launches"]) \
            != (2 * n, 2 * n):
        raise RuntimeError(f"(e) fd_hessian launched {counts}, expected "
                           f"{2 * n} + {2 * n}")
    fd32 = float(np.abs(Hf32 - H).max() / scale)
    check("(e) complex64 FD on streamK against AD", fd32, TOL_TP["fd32"])
    out["hessian"] = dict(sym=sym, fd=fd, fd32=fd32, eig=w_eig.tolist(),
                          wall=we[0], wall32=wf[0])
    phase(30, f"hessian on the scan (N = {pe.N}, {pe.setup.ntime} steps, "
              f"{n} parameters, f64): symmetry {sym:.2e}, fd_hessian (eps "
              f"1e-5) against AD {fd:.2e} x max(1, max|H|), eigenvalues "
              f"{np.array2string(w_eig, precision=3)}, {we[0]:.3f} s for "
              f"the three; hessian on the streamK route raises; fd_hessian "
              f"through it in complex64 (eps {TP_FD_EPS32}, "
              f"{counts['streamk_fwd_launches']} + "
              f"{counts['streamk_bwd_launches']} launches) against the f64 "
              f"AD {fd32:.2e} x max, {wf[0]:.3f} s")
    if bad:
        raise RuntimeError("phase 30 out of bounds: " + "; ".join(bad))
    return out


def time_parallel_phase_alone():
    """Phase 30 by itself (after a change to the time-parallel scan, the
    host-loop runner or the Hessian tools): the streamK build (for (e)),
    then time_parallel_phase."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    streamk.build_kernels(verbose=True)
    return time_parallel_phase(smi)


# Phase 31, multi-device on torch.distributed (parallel/mesh.py,
# parallel/multihost.py) and the profiler (profiling.py). The machine holds
# one card: (a) on a one-rank NCCL mesh, whose collectives sum one rank's
# share, the 'init' axis, the ensemble and the sweeps must be the
# unsharded run's bits; (b) two ranks sharing the card over gloo
# (processes of their own, `python3 chip_smoke.py --mesh-rank RANK PORT
# FILE`, loading the kernels phase 2 built) run the flagship's 'init' axis
# (B = 4, 2 a rank), the ensemble at MESH_E, its sweeps and the population
# optimizer on the streamK pair; (c) a profiler trace of one warm flagship
# sweep at E = 1.
MESH_E = 16             # (b)'s ensemble and population
MESH_POP_ITERS = 6
# (b) against one process: J abs, gradient x max (C4 item 11's class: the
# last bits of C-bar depend on E and B through the launch layout); the
# population's f trace and f_best relative (tests/test_sharding.py:235's)
TOL_MESH_J = 1e-6
TOL_MESH_G = 1e-5
TOL_MESH_POP = 2e-5


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def mesh_work(m):
    """(b)'s runs on mesh `m` (None: one process, unsharded): the
    flagship's value_and_grad on the 'init' axis, the ensemble of MESH_E
    candidates, two sweeps of it and MESH_POP_ITERS iterations of the
    population optimizer from phase 10's draw; numpy results, the route and
    batch a rank takes, and each run's launches."""
    p = Problem(flagship_setup())
    n = p.setup.nparams
    if m is not None:
        mesh.shard_problem(p, m)
    x = bench_params(n)
    out = dict(route=p.fused_form, ninit=p.ninit, launches={})

    def run(name, fn):
        reset_counts()
        res = fn()
        torch.cuda.synchronize()
        out["launches"][name] = {k: v for k, v in {
            **streamk.launch_counts(), **streamk_mid.launch_counts()}.items()
            if v}
        return res

    (J, aux), g = run("init", lambda: p.build_value_and_grad()(x, x))
    ens = Problem(flagship_setup())
    Ps = bench_params(n, MESH_E, seed=7)
    (Je, _), ge = run("ensemble", lambda: ens.build_ensemble_value_and_grad(
        mesh=m)(Ps, x))
    sw = run("sweeps", lambda: ens.build_ensemble_sweeps(mesh=m)(
        np.stack([Ps, Ps[::-1]]), x))
    bound = 15e-3 * 2 * np.pi / np.sqrt(2.0) / 2.0 * 3.0    # phase 10's box
    x0s = np.random.default_rng(1234).uniform(-1, 1, (MESH_E, n)) * 0.03
    pop = run("population", lambda: batched_lbfgsb(
        None, None, torch.as_tensor(x0s, device=p.device, dtype=torch.float32),
        -bound * np.ones(n, np.float32), bound * np.ones(n, np.float32),
        iters=MESH_POP_ITERS, ls_lengths=8,
        **ens.packed_batch_fns(np.zeros(n), mesh=m)))
    cpu = lambda t: t.detach().cpu().numpy()
    out.update(J=cpu(J), g=cpu(g), fidelity=cpu(aux["fidelity"]), Je=cpu(Je),
               ge=cpu(ge), sweeps=cpu(sw), pop=[cpu(t) for t in pop])
    return out


def mesh_rank(rank, port, out_path):
    """One of (b)'s two ranks: mesh_work on make_mesh(2, 1) over gloo,
    saved to `out_path` (np.save)."""
    multihost.initialize(f"localhost:{port}", 2, rank, backend="gloo")
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        np.save(out_path, mesh_work(mesh.make_mesh(2, 1)), allow_pickle=True)
    finally:
        dist.destroy_process_group()


def one_rank_nccl(x):
    """(a): the flagship's 'init' axis, the ensemble at E_BIG and two
    sweeps on a one-rank NCCL mesh, each a main path of its own (counts set
    to 0 before, read after), against the unsharded run's bits."""
    prob = Problem(flagship_setup())
    n = prob.setup.nparams
    Ps = bench_params(n, E_BIG, seed=7)
    Pr = np.stack([Ps, Ps[::-1]])
    (J0, aux0), g0 = prob.build_value_and_grad()(x, x)
    (Je0, auxe0), ge0 = prob.build_ensemble_value_and_grad()(Ps, x)
    sw0 = prob.build_ensemble_sweeps()(Pr, x)
    multihost.initialize(f"localhost:{free_port()}", 1, 0)
    try:
        backend = dist.get_backend()
        m1 = mesh.make_mesh(1, 1)
        ps = mesh.shard_problem(Problem(flagship_setup()), m1)
        reset_counts()
        (J1, aux1), g1 = ps.build_value_and_grad()(x, x)
        torch.cuda.synchronize()
        launches = dict(init=sweep_launches(B1))
        reset_counts()
        (Je1, auxe1), ge1 = prob.build_ensemble_value_and_grad(mesh=m1)(Ps, x)
        torch.cuda.synchronize()
        launches["ensemble"] = sweep_launches(B1)
        reset_counts()
        sw1 = prob.build_ensemble_sweeps(mesh=m1)(Pr, x)
        launches["sweeps"] = main_path_launches(B1)
    finally:
        dist.destroy_process_group()
    same = lambda a, b: bool(torch.equal(a, b))
    bits = dict(
        init=same(J1, J0) and same(g1, g0) and all(
            same(aux1[k], aux0[k]) for k in aux0),
        ensemble=same(Je1, Je0) and same(ge1, ge0) and all(
            same(auxe1[k], auxe0[k]) for k in auxe0),
        sweeps=same(sw1, sw0))
    if backend != "nccl" or ps.fused_form != "streamk" \
            or not all(bits.values()) \
            or any(launches["sweeps"][k] != 2 for k in B1):
        raise RuntimeError(f"phase 31(a): one-rank {backend} mesh against "
                           f"the unsharded run: bits {bits}, route "
                           f"{ps.fused_form}, launches {launches}")
    return dict(backend=backend, bits=bits, launches=launches)


def mesh_ranks_check(ranks, ref):
    """(b)'s two ranks against each other (bits) and against the one
    process's run (TOL_MESH_*); returns the errors."""
    r0, r1 = ranks
    keys = ("J", "g", "fidelity", "Je", "ge", "sweeps")
    bits = all(np.array_equal(r0[k], r1[k]) for k in keys) and all(
        np.array_equal(a, b) for a, b in zip(r0["pop"], r1["pop"]))
    rel = lambda a, b: float(np.abs(a - b).max() / np.abs(b).max())
    scale = 2 * (np.abs(ref["Je"]).sum() + np.abs(ref["ge"]).sum())
    errs = dict(
        J=float(abs(r0["J"] - ref["J"])), g_rel=rel(r0["g"], ref["g"]),
        Je=float(np.abs(r0["Je"] - ref["Je"]).max()),
        ge_rel=rel(r0["ge"], ref["ge"]),
        sweeps_rel=float(abs(r0["sweeps"] - ref["sweeps"]) / scale),
        pop_trace_rel=float(np.max(np.abs(r0["pop"][2] - ref["pop"][2])
                                   / np.abs(ref["pop"][2]))),
        pop_f_rel=float(np.max(np.abs(r0["pop"][1] - ref["pop"][1])
                               / np.abs(ref["pop"][1]))))
    ok = (bits and errs["J"] <= TOL_MESH_J and errs["Je"] <= TOL_MESH_J
          and max(errs["g_rel"], errs["ge_rel"], errs["sweeps_rel"])
          <= TOL_MESH_G
          and max(errs["pop_trace_rel"], errs["pop_f_rel"]) <= TOL_MESH_POP
          and all(r["route"] == "streamk" and r["ninit"] == 2
                  and r["launches"]["init"] == dict(zip(B1, (1, 1)))
                  and r["launches"]["ensemble"] == dict(zip(B1, (1, 1)))
                  for r in ranks))
    if not ok:
        raise RuntimeError(f"phase 31(b): two ranks on the card: bits "
                           f"{bits}, errors {errs}, routes "
                           f"{[r['route'] for r in ranks]}, launches "
                           f"{[r['launches'] for r in ranks]}")
    return dict(errs, bits=bits)


def trace_sweep(vg, x, logdir):
    """(c): profiling.trace around one warm flagship sweep at E = 1 (the
    user annotation 'sweep' spans it to its synchronization): each kernel's
    launches and device ms, the card's busy and idle share of the window,
    the streamK pair's share of it."""
    vg(x, x)
    torch.cuda.synchronize()
    with profiling.trace(logdir):
        with torch.profiler.record_function("sweep"):
            vg(x, x)
            torch.cuda.synchronize()
    summ = profiling.trace_summary(logdir, window="sweep")
    by_name = {}
    for name, (count, ms) in summ["kernels"].items():
        base = re.match(r"(?:void )?([A-Za-z_]\w*)", name).group(1)
        n0, ms0 = by_name.get(base, (0, 0.0))
        by_name[base] = (n0 + count, ms0 + ms)
    pair = {k: by_name.get(k, (0, 0.0)) for k in ("streamk_fwd", "streamk_bwd")}
    if any(c != 1 for c, _ in pair.values()):
        raise RuntimeError(f"phase 31(c): the trace of one sweep holds "
                           f"{pair} streamK launches: {by_name}")
    pair_ms = sum(ms for _, ms in pair.values())
    glue = {k: v for k, v in by_name.items() if k not in pair}
    return dict(window_ms=summ["window_ms"], busy_ms=summ["busy_ms"],
                busy_share=summ["busy_share"], idle_share=summ["idle_share"],
                streamk_ms={k: ms for k, (_, ms) in pair.items()},
                streamk_share=pair_ms / summ["window_ms"],
                other_kernels=sum(c for c, _ in glue.values()),
                other_kernel_ms=sum(ms for _, ms in glue.values()))


def mesh_phase(smi, rate_e1=None):
    """Phase 31: (b)'s two ranks start first; (a) and (b)'s one-process
    run go on beside them; (c) and sweep_timer's rate (against phase 6's
    `rate_e1`, sweeps/s at E = 1, measured here where None) once the ranks
    are done, the card to itself."""
    t0 = time.perf_counter()
    x = bench_params(flagship_setup().nparams)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_",
                           dir=cuda_build.BUILD_DIR)
    port = free_port()
    logs = [open(os.path.join(tmp, f"rank{r}.log"), "w") for r in (0, 1)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--mesh-rank", str(r),
         str(port), os.path.join(tmp, f"rank{r}.npy")], stdout=logs[r],
        stderr=subprocess.STDOUT) for r in (0, 1)]
    try:
        one = one_rank_nccl(x)
        ref = mesh_work(None)
        for r, p in enumerate(procs):
            if p.wait(timeout=300) != 0:
                logs[r].flush()
                with open(os.path.join(tmp, f"rank{r}.log")) as f:
                    raise RuntimeError(f"phase 31(b): rank {r} exited "
                                       f"{p.returncode}:\n{f.read()[-4000:]}")
        wall_b = time.perf_counter() - t0
        ranks = [np.load(os.path.join(tmp, f"rank{r}.npy"),
                         allow_pickle=True).item() for r in (0, 1)]
        two = mesh_ranks_check(ranks, ref)
        prob = Problem(flagship_setup())
        vg = prob.build_value_and_grad()
        tr = trace_sweep(vg, x, os.path.join(tmp, "trace"))
        rate = profiling.sweep_timer(vg, lambda i: (x, x), reps=20)
        if rate_e1 is None:
            rate_e1 = 1.0 / median_seconds(lambda: vg(x, x))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
        shutil.rmtree(tmp, ignore_errors=True)
    wall = time.perf_counter() - t0
    phase(31, f"(a) one-rank {one['backend']} mesh, the flagship on "
              f"'streamk': 'init' axis, E = {E_BIG} ensemble and 2 sweeps "
              f"the unsharded run's bits {json.dumps(one['bits'])}, launches "
              f"{json.dumps(one['launches'])}; (b) 2 ranks on the card over "
              f"gloo (B = 4, 2 a rank; E = {MESH_E}; {MESH_POP_ITERS} "
              f"population iterations), ranks the same bits "
              f"{two['bits']}, against one process "
              f"{json.dumps({k: v for k, v in two.items() if k != 'bits'})}"
              f" (bounds J {TOL_MESH_J}, gradient {TOL_MESH_G} x max, "
              f"population {TOL_MESH_POP}), launches a rank "
              f"{json.dumps(ranks[0]['launches'])}, {wall_b:.1f} s with (a); "
              f"(c) profiler trace of one warm sweep at E = 1: "
              f"{json.dumps(tr)}; sweep_timer {rate:.3f} sweeps/s against "
              f"phase 6's {rate_e1:.3f}; phase 31 {wall:.1f} s; card: {smi}")
    return dict(one=one, two=two, trace=tr, rate=rate, wall=wall)


def mesh_phase_alone():
    """Phase 31 by itself (after a change to parallel/, profiling.py or the
    ensemble entry points): the streamK build, then mesh_phase."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    streamk.build_kernels(verbose=True)
    return mesh_phase(smi)


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

    # phase 26's CPU references, computed by a worker on the host while the
    # card runs phases 2-25
    with cpu_reference_worker() as (worker, ref_path):
        run_phases(smi, worker, ref_path)


@contextlib.contextmanager
def cpu_reference_worker():
    """Starts phase 26's worker (cpu_references, in a process of its own
    that sees no card) and yields (the process, its output file); stops it
    on the way out, printing its log if it failed."""
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    ref_dir = tempfile.mkdtemp(prefix="chip_smoke_", dir=cuda_build.BUILD_DIR)
    ref_path = os.path.join(ref_dir, "cpu_references.pkl")
    with open(os.path.join(ref_dir, "worker.log"), "w") as log_f:
        worker = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--cpu-references",
             ref_path], stdout=log_f, stderr=subprocess.STDOUT,
            env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    try:
        yield worker, ref_path
    except BaseException:
        if worker.poll() is not None and worker.returncode != 0:
            with open(os.path.join(ref_dir, "worker.log")) as f:
                print(f"CPU reference worker (rc {worker.returncode}):\n"
                      + f.read()[-4000:], flush=True)
        raise
    finally:
        if worker.poll() is None:
            worker.kill()
            worker.wait()
        shutil.rmtree(ref_dir, ignore_errors=True)


def rho_mid_phase_alone():
    """Phase 26 by itself (after a change to csrc/rho_mid_fwd.cu or
    csrc/rho_mid.cu): the builds, then rho_mid_phase with its worker."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    with cpu_reference_worker() as (worker, ref_path):
        path, secs, log = rho_mid.build_kernels(verbose=True)
        phase(26, f"built {path} in {secs:.2f} s; "
                  + " | ".join(ptxas_lines(log)))
        return rho_mid_phase(smi, worker, ref_path)


def stream_mid_phase_alone():
    """Phase 27 by itself (after a change to csrc/stream_mid.cu): the
    build, phase 14's references of open configuration 2 (the rho route at
    full depth, the f64 port at NT_F64 steps), then stream_mid_phase."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    build = stream_mid.build_kernels(verbose=True)
    p16 = Problem(open_cnot_setup(True))
    P = torch.as_tensor(bench_params(p16.setup.nparams), device="cuda",
                        dtype=torch.float32)[None]
    ref, _ = f64_reference("cnot16", ntime=NT_F64)
    return stream_mid_phase(smi, build, (open_vg(p16, P), ref))


def per_block_phase_alone():
    """Phase 28 by itself (after a change to csrc/streamk_mid.cu or to the
    robust objective): the builds, open configuration 2 on the rho route
    (phase 14's sweep), then per_block_phase."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    cuda_build.build_parallel([streamk.build_kernels, rho.build_kernels,
                               stream_mid.build_kernels,
                               streamk_mid.build_kernels])
    p16 = Problem(open_cnot_setup(True))
    P = torch.as_tensor(bench_params(p16.setup.nparams), device="cuda",
                        dtype=torch.float32)[None]
    return per_block_phase(smi, p16, (open_vg(p16, P), None))


def run_phases(smi, worker, ref_path):
    """Phases 2-31 and the last lines."""
    # ---- 2. build ----
    t0 = time.perf_counter()
    ((path, secs, log), rho_build, stream_build, mid_build, rmid_build,
     smid_build) = cuda_build.build_parallel(
        [streamk.build_kernels, rho.build_kernels, stream.build_kernels,
         streamk_mid.build_kernels, rho_mid.build_kernels,
         stream_mid.build_kernels], verbose=True)
    phase(2, f"built {path} in {secs:.2f} s (all seven sources in "
             f"{time.perf_counter() - t0:.2f} s); "
          + " | ".join(ptxas_lines(log)) + f"; {mid_build[0]}: "
          + " | ".join(ptxas_lines(mid_build[2])))

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
    for name in OPEN14:
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
        # the f64 port on the CPU at NT_F64 steps (at full depth it took
        # 277 s of host time for the three configurations), computed by the
        # CPU reference worker while the card ran phases 2-13
        got_m = open_vg(Problem(fn(ntime=NT_F64)), P)
        ref, secs = worker_references(worker, ref_path + ".open14")[name]
        if name == "cnot16":
            open16 = got, ref      # phase 27's references
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
    # the plain runs of configuration 3 at PLAIN16_NT of their 1000 steps
    # (host-bound: 44 s at full depth on an H100 80GB HBM3 at 700 W)
    for name, pr, E, reps, plain in (
            ("cnot16", p16, 1, 3, True), ("cnot16_E8", p16, E_OPEN, 3, False),
            ("qutrits27", full["qutrits27"], 1, 2, PLAIN16_NT),
            ("qudits64", full["qudits64"], 1, 2, PLAIN16_NT)):
        P = to_card(bench_params(pr.setup.nparams, E, seed=7))
        C = pr.coeff_rows_mid(P)[..., 0, :].contiguous()
        ms_r[name] = rho_kernel_ms(pr._plan, pr._x0r, pr._x0i, C, reps,
                                   plain=plain)
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

    # ---- 19. the chunk route at dt/4 and the dense forward, cut to a
    # quarter of the horizon (the plain loop on the card and the f64 port
    # at NT_FINE took 42-48 s of the run on an H100 80GB HBM3 at 700 W;
    # phase 21 times the kernels at NT_FINE) ----
    pc = Problem(flagship_setup("neumann", 8, ntime=NT_FINE // 4,
                                fused_mode="chunk", T=50.0))
    if pc.fused_form != "chunk" or pc.linsolver != "neumann":
        raise RuntimeError(f"chunk route {pc.fused_form}, {pc.linsolver}")
    reset_counts()
    (Jc, _), gc = pc.build_value_and_grad()(x, x)
    torch.cuda.synchronize()
    launches_c = sweep_launches(B5)
    with plain_on_card():
        (Jcp, _), gcp = pc.build_value_and_grad()(x, x)
    pc64 = Problem(flagship_setup("neumann", 8, torch.complex128,
                                  ntime=NT_FINE // 4, T=50.0), device="cpu")
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
    phase(19, f"fused_mode='chunk' at dt/4, ntime {pc.setup.ntime} (T = "
              f"{pc.setup.total_time:g} ns): J={float(Jc):.8f} "
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

    # ---- 22-24. the front end ----
    fe = front_end(smi)

    # ---- 25. closed systems past one block: the mid pair ----
    mid = mid_phase(smi, prob._plan)

    # ---- 26. open systems past N = 64: the mid density-matrix pair ----
    rpath_m, rsecs_m, rlog_m = rmid_build
    phase(26, f"built {rpath_m} in {rsecs_m:.2f} s; "
              + " | ".join(ptxas_lines(rlog_m)))
    missing = [f"{k}<{ts}>" for k, tiles in (("rho_mid_fwd", (1, 2, 4)),
                                             ("rho_mid_bwd", (1, 2, 4)))
               for ts in tiles if f"{k}ILi{ts}E" not in rlog_m]
    if rsecs_m > 0 and missing:
        raise RuntimeError(f"ptxas reported no {missing}")
    rm = rho_mid_phase(smi, worker, ref_path)

    # ---- 27. the streamed-plane kernels past one block ----
    sm = stream_mid_phase(smi, smid_build, open16)

    # ---- 28. per-sample stacks and the open superop route past one block,
    # the open packed robust objective ----
    pb = per_block_phase(smi, p16, open16)

    # ---- 29. the large-N structured engines (no kernel of csrc/) ----
    large_n_phase(smi, worker_references(worker, ref_path + ".large_n"))

    # ---- 30. the time-parallel scan, the host-loop runner, the Hessian
    # tools ----
    time_parallel_phase(smi)

    # ---- 31. multi-device on torch.distributed, the profiler ----
    mp = mesh_phase(smi, rates["kernel_E1"])

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
                    launches_device_optimizer=launches_dev16[B4[i]],
                    launches_front_end=fe["open"]["optimize"][B4[i]],
                    launches_front_end_simulate=fe["open"]["simulate"][B4[i]])
        # the kernel's cluster per density matrix and its time per step
        # (reversed for rho_bwd), at configuration 2 and the others
        more["cluster"] = ms_r["cnot16"][f"{key}_cluster"]
        more["us_per_step"] = ms_r["cnot16"][f"{key}_us_per_step"]
        for name, t in ms_r.items():
            if "full_depth" in t:
                more[f"full_depth_{name}"] = t["full_depth"]
            if "plain_steps" in t:
                more[f"plain_steps_{name}"] = t["plain_steps"]
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

    def mid_more(i):
        """The mid pair at every size of phase 25: times, bounds, shapes,
        sweeps/s at 1000 steps, plain times at MID_NT_CUT steps; phase 28's
        open superop runs past one block (open 2, N = 27), their launches
        and interleaved times."""
        key = ("fwd", "bwd")[i]
        more = dict(launches_front_end=mid["fe"]["launches_optimize"][MID[i]],
                    launches_front_end_simulate=mid["fe"][
                        "launches_simulate"][MID[i]])
        for name in ("open2", "qutrits27"):
            t = pb[name]
            more[f"launches_superop_{name}"] = t["launches"][MID[i]]
            more[f"ms_superop_{name}"] = t["route_ms"]["superop_streamk"][
                f"{key}_mean"]
            more[f"bound_ms_superop_{name}"] = t["route_ms"][
                "superop_streamk"][f"{key}_bound"][0]
            more[f"plain_ms_superop_{name}"] = t["route_ms"][
                "superop_streamk"][f"plain_{key}"]
        for name, t in mid["full"].items():
            more[f"ms_{name}"] = t[key]
            more[f"bound_ms_{name}"] = t[f"{key}_bound"][0]
            more[f"shape_{name}"] = t[f"{key}_shape"]
            more[f"sweeps_per_s_{name}"] = t["sweeps_per_s"]
        for name, t in mid["plain_cut"].items():
            more[f"ms_{name}_nt{MID_NT_CUT}"] = t[key]
            more[f"plain_ms_{name}_nt{MID_NT_CUT}"] = t[f"plain_{key}"]
        if i == 1:
            more["schedules"] = {k: {c: v[c] for c in (
                "schedules_g0_bits", "schedules_cbar_rel", "stored_replayed")}
                for k, v in mid["schedules"].items()}
        else:
            # the record's case (n256_pure) ran on 'helpers'; each case's
            # planner schedule against the other one, interleaved
            more["schedule"] = mid["full"]["n256_pure"]["fwd_shape"][
                "schedule"]
            fs = dict(mid["fwd_schedules"], **{
                f"superop_{n}": pb[n]["fwd_schedules"]
                for n in ("open2", "qutrits27")},
                swap02_packed=pb["swap02_robust"]["fwd_schedules"],
                open8_packed=pb["open8_robust"]["fwd_schedules"])
            more["schedules"] = {k: dict(
                schedule=v["schedule"], helpers=v["helpers"],
                ms=statistics.mean(v["ms"]["planner"]), other=v["other"],
                ms_other=statistics.mean(v["ms"][v["other"]]),
                ratio=v["ratio"], bits=v["bits"] and v["bwd_bits"])
                for k, v in fs.items()}
        return more

    def rho_mid_more(i):
        """The mid density-matrix pair: its cluster and time per step at
        qudits125, qudits128's time and bound, sweeps/s, the front end's
        launches."""
        key = ("fwd", "bwd")[i]
        t125, t128 = rm["full"]["qudits125"], rm["full"]["qudits128"]
        return dict(cluster=t125[f"{key}_cluster"],
                    us_per_step=t125[f"{key}_us_per_step"],
                    stored=t125["stored"],
                    sweeps_per_s=rm["report"]["qudits125"]["sweeps_per_s"],
                    ms_qudits128=t128[key],
                    bound_ms_qudits128=t128[f"{key}_bound"][0],
                    cluster_qudits128=t128[f"{key}_cluster"],
                    launches_front_end=rm["fe"]["launches_optimize"][
                        RHO_MID[i]],
                    launches_front_end_simulate=rm["fe"][
                        "launches_simulate"][RHO_MID[i]],
                    **({} if i == 0 else dict(
                        split_EB24_G16_s=rm["wide"]["split_s"],
                        split_EB24_clusters_held=rm["wide"]["holds"])))

    def smid_more(i):
        """The mid stream pair: its shape and sweeps/s at N = 256, N = 512's
        time, bound, plain time and shape, the open superop run's launches
        and the routes' agreement."""
        key = ("fwd", "bwd")[i]
        t256, t512 = sm["full"]["n256_pure"], sm["full"]["n512_pure"]
        more = {}
        if i == 1:      # the backward's schedules, interleaved
            scheds = dict(n256_pure=t256["schedules"],
                          n512_pure=t512["schedules"],
                          chunk256=sm["chunk"]["schedules"],
                          open2=sm["open"]["schedules"])
            more = dict(schedule=t256["bwd_shape"]["schedule"], schedules={
                k: dict(schedule=v["schedule"], bits=v["bits"],
                        ms_helpers=statistics.mean(v["ms"]["helpers"]),
                        ms_chain=statistics.mean(v["ms"]["chain"]),
                        ratio=v["ratio"]) for k, v in scheds.items()})
        if i == 0:      # 'chunk' at N = 1024, the layouts' bits
            wide = sm["chunk1024"]
            more = dict(ms_chunk1024=wide["ms"],
                        bound_ms_chunk1024=wide["bound"][0],
                        plain_ms_chunk1024=wide["plain_ms"],
                        shape_chunk1024=wide["shape"],
                        layouts_same_bits=sm["fwd_layout_bits"])
        return dict(more, shape=t256[f"{key}_shape"],
                    sweeps_per_s=t256["sweeps_per_s"],
                    ms_n512=t512[key], bound_ms_n512=t512[f"{key}_bound"][0],
                    plain_ms_n512=t512[f"plain_{key}"],
                    shape_n512=t512[f"{key}_shape"],
                    sweeps_per_s_n512=t512["sweeps_per_s"],
                    launches_open_superop=sm["open"]["launches"][SMID[i]],
                    routes_n256=t256["routes"], routes_n512=t512["routes"])

    def open1_more(key):
        """Phase 28's open packed robust gradient on one block (open 1,
        S = 8)."""
        t = pb["open1_robust"]
        return dict(launches_open1_S8=t["launches"][B2[key == "bwd"]],
                    ms_open1_S8=t["ms"][key],
                    bound_ms_open1_S8=t["ms"][f"{key}_bound"][0],
                    plain_ms_open1_S8=t["ms"][f"plain_{key}"],
                    walls_open1_S8=t["walls"])

    def pb_more(i):
        """The mid pair on per-block plans: the closed SWAP02 ensemble's and
        open 1's packed times ride along with the three open qubits'."""
        key = ("fwd", "bwd")[i]
        more = dict(shape=pb["open8_robust"]["shapes"][key],
                    walls=pb["open8_robust"]["walls"])
        t = pb["swap02_robust"]
        more.update(launches_swap02=t["launches"][MIDP[i]],
                    ms_swap02=t["ms"][key],
                    bound_ms_swap02=t["ms"][f"{key}_bound"][0],
                    plain_ms_swap02=t["ms"][f"plain_{key}"],
                    shape_swap02=t["shapes"][key], walls_swap02=t["walls"])
        return more

    def chain_more(name):
        """A stream.cu kernel's time per (reversed) step and helpers."""
        c = chain_s[name]
        return dict(helpers=c["helper_threads"], **{
            k: c[k] for k in ("us_per_step", "us_per_step_E128") if k in c})

    # library_ms is null: no single PyTorch call computes a whole
    # propagation (a time loop of stage solves) or its transpose
    print(json.dumps({"kernels": [
        record("streamk_fwd", 907, launches[B1[0]], worst["state"], ms, "fwd",
               launches_front_end=fe["cnot"]["optimize"][B1[0]],
               launches_front_end_simulate=fe["cnot"]["simulate"][B1[0]],
               launches_device_optimizer=launches_dev[B1[0]],
               launches_population=launches_pop[B1[0]],
               launches_mesh=mp["one"]["launches"]["init"][B1[0]],
               **streamk_more(0)),
        record("streamk_bwd", 967, launches[B1[1]],
               max(worst["cbar"], worst["x0bar"]), ms, "bwd",
               launches_front_end=fe["cnot"]["optimize"][B1[1]],
               launches_device_optimizer=launches_dev[B1[1]],
               launches_population=launches_pop[B1[1]],
               launches_mesh=mp["one"]["launches"]["init"][B1[1]],
               **streamk_more(1)),
        record("streamk_packed_fwd", 1324, launches_robust[B2[0]],
               worst_p["state"], ms_p, "fwd", ms_S128=ms_pbig["fwd"],
               bound_ms_S128=ms_pbig["fwd_bound"][0],
               **open1_more("fwd")),
        record("streamk_packed_bwd", 1415, launches_robust[B2[1]],
               max(worst_p["cbar"], worst_p["x0bar"]), ms_p, "bwd",
               ms_S128=ms_pbig["bwd"], bound_ms_S128=ms_pbig["bwd_bound"][0],
               **open1_more("bwd")),
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
               **chain_more("dense_fwd")),
        # the mid pair at midsize_bench's N = 256 (B = 1, 1000 steps, the
        # plain version at the same depth); the other sizes ride along,
        # their plain times at MID_NT_CUT steps
        record("streamk_mid_fwd", 907, mid["launches"][MID[0]],
               mid["worst"]["state"], mid["full"]["n256_pure"], "fwd",
               src=MID_SRC, **mid_more(0)),
        record("streamk_mid_bwd", 967, mid["launches"][MID[1]],
               max(mid["worst"]["cbar"], mid["worst"]["x0bar"]),
               mid["full"]["n256_pure"], "bwd", src=MID_SRC,
               **mid_more(1)),
        # the mid density-matrix pair at qudits125 (N = 125, B = 3, 1000
        # steps, E = 1, the plain version at the same depth); qudits128
        # rides along
        record("rho_mid_fwd", 374, rm["launches"][RHO_MID[0]],
               rm["worst"]["state"], rm["full"]["qudits125"], "fwd",
               src=RHO_MID_FWD_SRC, tpu="quandary_tpu/ops/pallas_rho.py",
               **rho_mid_more(0)),
        record("rho_mid_bwd", 494, rm["launches"][RHO_MID[1]],
               max(rm["worst"]["cbar"], rm["worst"]["x0bar"]),
               rm["full"]["qudits125"], "bwd", src=RHO_MID_SRC,
               tpu="quandary_tpu/ops/pallas_rho.py", **rho_mid_more(1)),
        # the mid streamed-plane pair: 'stream' at midsize_bench's N = 256
        # (B = 1, 1000 steps, split-4, the plain version at the same
        # depth), N = 512 riding along; 'chunk' and dense on N = 256 at
        # CHUNK_MID_T (1000 steps, neumann-8)
        record("stream_mid_fwd", 613, sm["launches"][SMID[0]],
               sm["worst"]["stream"]["state"], sm["full"]["n256_pure"],
               "fwd", src=SMID_SRC, **smid_more(0)),
        record("stream_mid_bwd", 657, sm["launches"][SMID[1]], max(
            sm["worst"]["stream"][k] for k in ("cbar", "x0bar", "sbar")),
               sm["full"]["n256_pure"], "bwd", src=SMID_SRC,
               **smid_more(1)),
        record("chunk_mid_fwd", 202, sm["launches"][CMID[0]],
               sm["worst"]["chunk"]["state"], sm["chunk"], "fwd",
               src=SMID_SRC, tpu="quandary_tpu/ops/pallas_adjoint.py",
               shape=sm["chunk"]["fwd_shape"]),
        record("chunk_mid_bwd", 211, sm["launches"][CMID[1]], max(
            sm["worst"]["chunk"][k] for k in ("cbar", "x0bar", "sbar")),
               sm["chunk"], "bwd", src=SMID_SRC,
               tpu="quandary_tpu/ops/pallas_adjoint.py",
               shape=sm["chunk"]["bwd_shape"],
               schedule=sm["chunk"]["bwd_shape"]["schedule"]),
        record("dense_mid_fwd", 111, sm["launches"][DMID[0]],
               sm["worst"]["dense"], sm["dense"], "fwd", src=SMID_SRC,
               tpu="quandary_tpu/ops/pallas_kernels.py",
               shape=sm["dense"]["fwd_shape"]),
        # the mid pair on per-block plans (the packed entry of B2 past one
        # block) at the open packed robust gradient of three qubits (S = 2,
        # dim 64, 64 density matrices, SWAP02_OPEN_NT steps)
        record("streamk_mid_packed_fwd", 1324,
               pb["open8_robust"]["launches"][MIDP[0]], pb["worst"]["state"],
               pb["open8_robust"]["ms"], "fwd", src=MID_SRC, **pb_more(0)),
        record("streamk_mid_packed_bwd", 1415,
               pb["open8_robust"]["launches"][MIDP[1]],
               max(pb["worst"]["cbar"], pb["worst"]["x0bar"]),
               pb["open8_robust"]["ms"], "bwd", src=MID_SRC, **pb_more(1))]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cpu-references"]:
        cpu_references(sys.argv[2])
    elif sys.argv[1:2] == ["--mesh-rank"]:
        mesh_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    else:
        main()
