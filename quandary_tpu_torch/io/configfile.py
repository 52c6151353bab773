"""Reference config-file (.cfg) compatibility layer.

Parses the key=value config format (config.cpp) and builds a
:class:`~quandary_tpu_torch.problem.Setup` plus run options, replicating the
construction logic of the reference driver (main.cpp:24-442), as
quandary_tpu/io/configfile.py does. The Setup is complex128 with
``fused='auto'``: the plain time loop, on the CPU or the card.

A standard model with N > 1024 takes the structured engines
(ops/tensor_rhs.py), as the JAX package's front end does.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..models import gates as gates_mod
from ..models.hamiltonian import build_file_model, build_standard_model
from ..ops.tensor_rhs import build_structured_model
from ..problem import Setup
from ..utils.indexing import ess_to_full_map
from ..utils.splines import ControlSegment, OscillatorControl
from . import datafiles


class Config(dict):
    """key = value parser with comma-separated values (config.cpp:37-97)."""

    @classmethod
    def read(cls, path: str) -> "Config":
        cfg = cls()
        with open(path) as f:
            for line in f:
                line = line.split("#")[0].strip()
                if not line or "=" not in line:
                    continue
                key, _, val = line.partition("=")
                cfg[key.strip()] = val.strip()
        return cfg

    def get_str(self, key, default=""):
        return self.get(key, default)

    def get_int(self, key, default=0):
        return int(float(self.get(key, default)))

    def get_double(self, key, default=0.0):
        return float(self.get(key, default))

    def get_bool(self, key, default=False):
        v = str(self.get(key, default)).strip().lower()
        return v in ("true", "1", "yes")

    def get_vec_double(self, key, default=0.0) -> List[float]:
        if key not in self:
            return [float(default)]
        return [float(s) for s in str(self[key]).split(",") if s.strip() != ""]

    def get_vec_str(self, key, default="") -> List[str]:
        if key not in self:
            return [default] if default != "" else []
        return [s.strip() for s in str(self[key]).split(",") if s.strip() != ""]


def copy_last(vec: List, n: int) -> List:
    """Fill by repeating the last element (util.hpp:267 copyLast).
    An empty vector (a present-but-blank config value) raises a clear
    error instead of IndexError deep inside."""
    vec = list(vec)
    if not vec and n > 0:
        raise ValueError(
            "empty value list where at least one entry is required "
            "(a config key is present but blank)")
    while len(vec) < n:
        vec.append(vec[-1])
    return vec[:n]


def _parse_segments(tokens: List[str], total_time: float) -> List[ControlSegment]:
    """control_segments<k> string parser (oscillator.cpp:48-132)."""
    segs: List[ControlSegment] = []
    i = 0
    while i < len(tokens):
        t = tokens[i]
        if t == "step":
            amp1 = float(tokens[i + 1]); amp2 = float(tokens[i + 2])
            tramp = float(tokens[i + 3]); i += 4
            tstart, tstop = 0.0, total_time
            if len(tokens) >= i + 2:
                tstart = float(tokens[i]); tstop = float(tokens[i + 1]); i += 2
            segs.append(ControlSegment("step", tstart=tstart, tstop=tstop,
                                       step_amp1=amp1, step_amp2=amp2, tramp=tramp))
        elif t in ("spline", "spline0"):
            ns = int(tokens[i + 1]); i += 2
            tstart, tstop = 0.0, total_time
            if len(tokens) >= i + 2:
                tstart = float(tokens[i]); tstop = float(tokens[i + 1]); i += 2
            segs.append(ControlSegment(t, nsplines=ns, tstart=tstart, tstop=tstop))
        elif t == "spline_amplitude":
            ns = int(tokens[i + 1]); scaling = float(tokens[i + 2]); i += 3
            tstart, tstop = 0.0, total_time
            if len(tokens) >= i + 2:
                tstart = float(tokens[i]); tstop = float(tokens[i + 1]); i += 2
            segs.append(ControlSegment("spline_amplitude", nsplines=ns,
                                       tstart=tstart, tstop=tstop, scaling=scaling))
        else:
            i += 1
    return segs


def _init_params_for_osc(osc: OscillatorControl, init_tokens: List[str],
                         rand_seed: Optional[int] = None):
    """Initial parameter values for one oscillator
    (oscillator.cpp:134-205). Returns (values, from_file_name|None).
    Amplitudes in the config are multiplied by 2*pi. 'random' draws are
    bit-exact with the reference when the native std::mt19937 library is
    available (the engine restarts per oscillator, matching the reference's
    pass-by-value engine copy, main.cpp:240); numpy fallback otherwise."""
    nf = len(osc.carrier_freqs)
    vals: List[float] = []
    idini = 0
    tokens = list(init_tokens)

    # ONE uniform stream per oscillator, consumed sequentially across the
    # random blocks: the reference copies the seeded engine into each
    # oscillator (pass-by-value, main.cpp:240) and draws from that single
    # copy across all its segments/carriers (oscillator.cpp:164-189).
    # Restarting per segment/carrier block would make every carrier's
    # random coefficients byte-identical.
    n_random = 0
    scan = 0
    for seg in osc.segments:
        mode = tokens[scan] if len(tokens) > scan else "constant"
        if mode == "random":
            n_random += nf * seg.nparams_per_carrier()
        scan += 2
    pool = None
    cursor = 0
    if n_random:
        from .native import mt19937_uniform
        pool = mt19937_uniform(int(rand_seed or 0), n_random) \
            if rand_seed is not None else None
        if pool is None:
            pool = np.random.default_rng(rand_seed).uniform(
                0.0, 1.0, n_random)

    for seg in osc.segments:
        if len(tokens) < idini + 2:
            tokens.append("constant")
            tokens.append("1.0" if seg.kind == "step" else "0.0")
        mode = tokens[idini]
        if mode == "file":
            return None, tokens[idini + 1]
        initval = float(tokens[idini + 1]) * 2.0 * np.pi
        npc = seg.nparams_per_carrier()
        for f in range(nf):
            if mode == "constant":
                v = initval
                if seg.kind == "step":
                    v = min(max(v, 0.0), 1.0)
                block = [v] * npc
            elif mode == "random":
                u = pool[cursor:cursor + npc]
                cursor += npc
                r = u * initval
                block = list(2.0 * r - initval)
            else:
                block = [0.0] * npc
            if seg.kind == "spline_amplitude":
                block[-1] = float(tokens[idini + 2]) if len(tokens) > idini + 2 else 0.0
            vals.extend(block)
        idini += 2
    # boundary enforcement
    if osc.enforce_bc:
        off = 0
        for seg in osc.segments:
            npc = seg.nparams_per_carrier()
            ns = seg.nsplines
            for f in range(nf):
                base = off + f * npc
                if seg.kind == "spline":
                    for l in (0, 1, ns - 2, ns - 1):
                        vals[base + l] = 0.0
                        vals[base + ns + l] = 0.0
                elif seg.kind == "spline_amplitude":
                    for l in (0, 1, ns - 2, ns - 1):
                        vals[base + l] = 0.0
                elif seg.kind == "spline0":
                    vals[base + 0] = 0.0
                    vals[base + ns - 1] = 0.0
                    vals[base + ns] = 0.0
                    vals[base + 2 * ns - 1] = 0.0
            off += npc * nf
    return np.asarray(vals), None


@dataclasses.dataclass
class RunSpec:
    runtype: str
    datadir: str
    output_frequency: int
    optim_monitor_freq: int
    outputs: List[List[str]]          # per oscillator output strings
    maxiter: int
    gatol: float
    grtol: float
    fatol: float
    inftol: float
    params0: np.ndarray
    control_bounds: List[List[float]]  # GHz per oscillator/segment
    warmstart: bool = False           # resume from datadir/optim_state.npz
                                      # (extension key `optim_resume`; the
                                      # reference's warm start is params-only
                                      # via control_initialization = file)
    optim_driver: str = "host"        # host | device | auto (extension key:
                                      # 'device' runs the chunked on-device
                                      # L-BFGS-B loop, optim/device_driver.py;
                                      # 'auto' selects it for a problem on a
                                      # CUDA device. CLI default is 'host' —
                                      # the reference-faithful f64 Wolfe
                                      # driver — so config-file golden
                                      # parity is device-independent)


def setup_from_config(cfg: Config, workdir: str = ".") -> Tuple[Setup, RunSpec]:
    """Replicates main.cpp:24-442 + OptimProblem config parsing."""
    nlevels = [int(v) for v in cfg.get_vec_double("nlevels")]
    Q = len(nlevels)
    nessential = [int(v) for v in cfg.get_vec_double("nessential", 0)]
    if nessential == [0]:
        nessential = list(nlevels)
    nessential = copy_last(nessential, Q)

    ntime = cfg.get_int("ntime", 1000)
    dt = cfg.get_double("dt", 0.01)
    total_time = ntime * dt

    transfreq = copy_last(cfg.get_vec_double("transfreq", 1e20), Q)
    rotfreq = copy_last(cfg.get_vec_double("rotfreq", 1e20), Q)
    selfkerr = copy_last(cfg.get_vec_double("selfkerr", 0.0), Q)
    collapse = cfg.get_str("collapse_type", "none")
    decay = copy_last(cfg.get_vec_double("decay_time", 0.0), Q)
    dephase = copy_last(cfg.get_vec_double("dephase_time", 0.0), Q)
    lindblad = collapse != "none"
    use_decay = collapse in ("decay", "both")
    use_dephase = collapse in ("dephase", "both")

    npairs = Q * (Q - 1) // 2
    crosskerr = copy_last(cfg.get_vec_double("crosskerr", 0.0), max(npairs, 1))[:npairs]
    jkl = copy_last(cfg.get_vec_double("Jkl", 0.0), max(npairs, 1))[:npairs]

    # --- control segments / carriers / initialization ---
    oscillators: List[OscillatorControl] = []
    enforce_bc = cfg.get_bool("control_enforceBC", True)
    default_seg = ["spline", "10", "0.0", str(total_time)]
    default_init = ["constant", "0.0"]
    init_tokens_all = []
    for k in range(Q):
        seg_tokens = cfg.get_vec_str(f"control_segments{k}") or default_seg
        init_tokens = cfg.get_vec_str(f"control_initialization{k}") or default_init
        carriers = cfg.get_vec_double(f"carrier_frequency{k}", 0.0)
        segs = _parse_segments(seg_tokens, total_time)
        oscillators.append(OscillatorControl(
            segments=tuple(segs),
            carrier_freqs=tuple(2.0 * np.pi * f for f in carriers),
            enforce_bc=enforce_bc))
        init_tokens_all.append(init_tokens)
        default_seg = seg_tokens
        default_init = init_tokens

    # initial parameter vector
    rand_seed = cfg.get_int("rand_seed", -1)
    rand_seed = rand_seed if rand_seed >= 0 else None
    params_chunks = []
    file_name = None
    for osc, init_tokens in zip(oscillators, init_tokens_all):
        vals, fname = _init_params_for_osc(osc, init_tokens, rand_seed)
        if fname is not None:
            file_name = fname
            params_chunks = None
            break
        params_chunks.append(vals)
    ndesign = sum(o.nparams for o in oscillators)
    if file_name is not None:
        path = file_name if os.path.isabs(file_name) else os.path.join(workdir, file_name)
        params0 = datafiles.read_vector(path)[:ndesign]
    else:
        params0 = np.concatenate(params_chunks) if params_chunks else np.zeros(0)

    # pi pulses (main.cpp:249-277): zero-amp windows on all other oscillators
    pipulses = [[] for _ in range(Q)]
    pp = cfg.get_vec_str("apply_pipulse", "none")
    if pp and pp[0] != "none":
        k = 0
        while k + 3 < len(pp):
            pid = int(pp[k]); t0 = float(pp[k + 1]); t1 = float(pp[k + 2]); amp = float(pp[k + 3])
            for i in range(Q):
                pipulses[i].append((t0, t1, amp if i == pid else 0.0))
            k += 4

    # --- model ---
    h_sys_file = cfg.get_str("hamiltonian_file_Hsys", "none")
    h_c_file = cfg.get_str("hamiltonian_file_Hc", "none")
    N = int(np.prod(nlevels))
    if h_sys_file != "none" or h_c_file != "none":
        Hsys = np.zeros((N, N), dtype=np.complex128)
        Hc_re = [np.zeros((N, N)) for _ in range(Q)]
        Hc_im = [np.zeros((N, N)) for _ in range(Q)]
        if h_sys_file != "none":
            p = h_sys_file if os.path.isabs(h_sys_file) else os.path.join(workdir, h_sys_file)
            Hsys = datafiles.read_hamiltonian_sys(p, N)
        if h_c_file != "none":
            p = h_c_file if os.path.isabs(h_c_file) else os.path.join(workdir, h_c_file)
            Hc_re, Hc_im = datafiles.read_hamiltonian_ctrl(p, N, Q)
        model = build_file_model(
            nlevels=nlevels, Hsys_radns=Hsys, Hc_re=Hc_re, Hc_im=Hc_im,
            decay_time=decay if use_decay else [0.0] * Q,
            dephase_time=dephase if use_dephase else [0.0] * Q,
            lindblad=lindblad)
    else:
        # Standard model: the dense operator stack, and past N = 1024 the
        # structured engines (ops/tensor_rhs.py; the dense (K, N, N) stack
        # would not fit for e.g. nlevels 32,32,32,32). 'usematfree' (the
        # reference's matrix-free-kernels hint, main.cpp:290-314) is
        # consumed but ADVISORY: it selects between the reference's two
        # mathematically-identical RHS implementations.
        cfg.get_bool("usematfree", False)
        if N > 1024:
            model = build_structured_model(
                nlevels=nlevels, freq01_ghz=transfreq, rotfreq_ghz=rotfreq,
                selfkerr_ghz=selfkerr, crosskerr_ghz=crosskerr, jkl_ghz=jkl,
                decay_time=decay if use_decay else [0.0] * Q,
                dephase_time=dephase if use_dephase else [0.0] * Q,
                lindblad=lindblad)
        else:
            model = build_standard_model(
                nlevels=nlevels, freq01_ghz=transfreq, rotfreq_ghz=rotfreq,
                selfkerr_ghz=selfkerr, crosskerr_ghz=crosskerr, jkl_ghz=jkl,
                decay_time=decay if use_decay else [0.0] * Q,
                dephase_time=dephase if use_dephase else [0.0] * Q,
                lindblad=lindblad)

    # --- initial conditions ---
    ic_tokens = cfg.get_vec_str("initialcondition", "basis")
    ic_type = ic_tokens[0]
    pure_levels = None
    init_state = None
    ic_ids: Tuple[int, ...] = ()
    if ic_type == "pure":
        pure_levels = tuple(int(t) for t in ic_tokens[1:]) or tuple([0] * Q)
    elif ic_type == "file":
        dim_ess = int(np.prod(nessential))
        p = ic_tokens[1]
        p = p if os.path.isabs(p) else os.path.join(workdir, p)
        init_state = datafiles.read_complex_state(p, dim_ess, lindblad)
    else:
        ic_ids = tuple(int(t) for t in ic_tokens[1:] if t not in ("",))

    # --- target ---
    tgt = cfg.get_vec_str("optim_target", "pure")
    target_type = "none"
    target_gate_full = None
    target_state_full = None
    pure_target_levels = None
    gate_rot = cfg.get_vec_double("gate_rot_freq", 1e20)
    if gate_rot[0] >= 1e19:
        gate_rot = [0.0] * Q
    gate_rot = copy_last(gate_rot, Q)
    target_batch_fn = None
    if tgt[0] == "gate":
        gname = tgt[1] if len(tgt) > 1 else "none"
        dim_ess = int(np.prod(nessential))
        if gname == "file":
            p = tgt[2]
            p = p if os.path.isabs(p) else os.path.join(workdir, p)
            Vess = gates_mod.read_gate_file(p, dim_ess)
        elif dim_ess > 1024 and gname in gates_mod.PERMUTATION_GATES:
            # large N: never materialize the gate; apply the permutation to
            # the initial-condition batch lazily (after it is built below)
            Vess = None
            target_type = "gate"
            target_batch_fn = lambda x0: gates_mod.apply_permutation_gate_to_states(
                gname, x0, nlevels, nessential, gate_rot, total_time, lindblad)
        else:
            Vess = gates_mod.from_name(gname, nessential)
        if Vess is not None:
            target_type = "gate"
            target_gate_full = gates_mod.assemble_gate(
                Vess, nlevels, nessential, gate_rot, total_time)
    elif tgt[0] == "pure":
        target_type = "pure"
        lv = [int(t) for t in tgt[1:]] if len(tgt) > 1 else [0] * Q
        lv = copy_last(lv, Q)
        pure_target_levels = tuple(lv)
    elif tgt[0] == "file":
        target_type = "file"
        dim_ess = int(np.prod(nessential))
        p = tgt[1]
        p = p if os.path.isabs(p) else os.path.join(workdir, p)
        ess = datafiles.read_complex_state(p, dim_ess, lindblad)
        emap = ess_to_full_map(nlevels, nessential)
        if lindblad:
            full = np.zeros((N, N), dtype=np.complex128)
            full[np.ix_(emap, emap)] = ess
        else:
            full = np.zeros((N,), dtype=np.complex128)
            full[emap] = ess
        target_state_full = full

    target_batch = None
    if target_batch_fn is not None:
        from ..models.initialconditions import build_initial_states
        osc_ids_t = ic_ids if len(ic_ids) > 0 else tuple(range(Q))
        x0_np, _ = build_initial_states(
            ic_type, nlevels, nessential, osc_ids_t, lindblad,
            pure_levels=pure_levels, from_file_state=init_state)
        target_batch = target_batch_fn(x0_np)

    setup = Setup(
        model=model,
        nessential=tuple(nessential),
        ntime=ntime,
        dt=dt,
        timestepper=cfg.get_str("timestepper", "IMR"),
        linsolve_iters=cfg.get_int("linearsolver_maxiter", 20),
        # 'linearsolver_type' (gmres|neumann) is consumed but ADVISORY: it
        # picks between two solvers for the SAME IMR stage equations, and
        # fixed-iteration Neumann with the stiffness-guard upgrade to the
        # Jacobi-preconditioned iteration reaches machine-precision
        # residuals where the reference's unpreconditioned GMRES warns
        # above 1e-3 (timestepper.cpp:612). An explicit GMRES stage solve
        # remains available via Setup.linsolver='gmres'.
        linsolver="neumann",
        oscillators=tuple(oscillators),
        pipulses=tuple(pipulses) if any(len(p) for p in pipulses) else None,
        ground_freqs_radns=tuple(2.0 * np.pi * f for f in transfreq),
        initcond_type=ic_type,
        initcond_ids=ic_ids,
        pure_levels=pure_levels,
        initial_state_ess=init_state,
        target_type=target_type,
        target_gate_full=target_gate_full,
        target_state_full=target_state_full,
        target_batch=target_batch,
        pure_target_levels=pure_target_levels,
        objective_type={"Jfrobenius": "Jfrobenius", "Jtrace": "Jtrace",
                        "Jmeasure": "Jmeasure"}[cfg.get_str("optim_objective", "Jtrace")],
        obj_weights=np.asarray(cfg.get_vec_double("optim_weights", 1.0)),
        gamma_tik=cfg.get_double("optim_regul", 1e-4),
        # 'optim_regul_interpolate' is the deprecated alias the reference
        # still honors (optimproblem.cpp:107-111)
        gamma_tik_interpolate=cfg.get_bool(
            "optim_regul_tik0",
            cfg.get_bool("optim_regul_interpolate", False)),
        gamma_penalty=cfg.get_double("optim_penalty", 0.0),
        penalty_param=cfg.get_double("optim_penalty_param", 0.5),
        gamma_penalty_dpdm=(0.0 if lindblad else cfg.get_double("optim_penalty_dpdm", 0.0)),
        gamma_penalty_energy=cfg.get_double("optim_penalty_energy", 0.0),
        gamma_penalty_variation=cfg.get_double("optim_penalty_variation", 0.01),
        fused="auto",
    )
    # np_optim: the reference's reserved time-parallel axis, hard-coded to
    # size 1 there (main.cpp:140-143); consumed for config_log parity.
    cfg.get_int("np_optim", 1)

    bounds = []
    for k in range(Q):
        bounds.append(cfg.get_vec_double(f"control_bounds{k}", 1e4))
    outputs = [cfg.get_vec_str(f"output{k}", "none") for k in range(Q)]

    runspec = RunSpec(
        runtype=cfg.get_str("runtype", "simulation"),
        datadir=cfg.get_str("datadir", "./data_out"),
        output_frequency=cfg.get_int("output_frequency", 1),
        optim_monitor_freq=cfg.get_int("optim_monitor_frequency", 10),
        outputs=outputs,
        maxiter=cfg.get_int("optim_maxiter", 200),
        gatol=cfg.get_double("optim_atol", 1e-8),
        grtol=cfg.get_double("optim_rtol", 1e-4),
        fatol=cfg.get_double("optim_ftol", 1e-8),
        inftol=cfg.get_double("optim_inftol", 1e-5),
        params0=params0,
        control_bounds=bounds,
        warmstart=cfg.get_str("optim_resume", "false").lower() in
        ("true", "yes", "1"),
        optim_driver=cfg.get_str("optim_driver", "host").lower(),
    )
    return setup, runspec
