"""The front end's host layers of quandary_tpu_torch against quandary_tpu:
the same inputs, made from a seed with numpy, through both packages.

1. utils/resonances.py: the derived time steps and carrier frequencies;
2. io/native.py (the port's own build of csrc/quandary_native.cpp):
   std::mt19937 draws, the triplet and table readers, the state-row writer,
   bit for bit and byte for byte;
3. io/datafiles.py round trips, and byte-equal files;
4. the trajectory writers of io/output.py byte-equal to the JAX writers;
5. io/configfile.py: config_template.cfg and the configs of
   tests/test_configfile.py give equal stacks, x0, targets, oscillators,
   params0 and RunSpec;
6. ops/steppers.py: one step of IMR4, IMR8, explicit Euler and the GMRES
   stage solve equal to the JAX make_step_fn in f64 to 1e-12; the step's
   device constants built once, with the bits of the step that copied them
   in every call; the hand-written transpose of the stage solves equal to
   autograd through the unrolled iterations;
7. ops/solvers.py: reduced populations and expected energies equal.
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from quandary_tpu.io import datafiles as jdata  # noqa: E402
from quandary_tpu.io import native as jnative  # noqa: E402
from quandary_tpu.io import output as jout  # noqa: E402
from quandary_tpu_torch.io import datafiles as tdata  # noqa: E402
from quandary_tpu_torch.io import native as tnative  # noqa: E402
from quandary_tpu_torch.io import output as tout  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FREQ01 = [4.80595, 4.8601]


def _native_pair():
    if jnative.get_lib() is None or tnative.get_lib() is None:
        pytest.skip("no g++ to build the native libraries")
    return jnative, tnative


def _same_bytes(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read(), (a, b)


# ---- 1. resonances ----

@pytest.mark.parametrize("case", ["cnot", "guard3", "three_qubits"])
def test_resonances_equal(case):
    from quandary_tpu.utils import resonances as jres
    from quandary_tpu_torch.utils import resonances as tres
    from quandary_tpu_torch.utils.operators import hamiltonians
    Ne, Ng, freq, kerr, jkl = {
        "cnot": ([2, 2], [0, 0], FREQ01, [0.2198, 0.2252], [0.005]),
        "guard3": ([2, 2], [1, 1], FREQ01, [0.2198, 0.2252], [0.005]),
        "three_qubits": ([2, 2, 2], [0, 0, 0], [5.06, 5.12, 5.18],
                         [0.2, 0.21, 0.22], [5e-3, 0.0, 5e-3]),
    }[case]
    N = [e + g for e, g in zip(Ne, Ng)]
    rot = [float(np.mean(freq))] * len(Ne)
    Hsys, Hc_re, Hc_im = hamiltonians(N=N, freq01=freq, selfkerr=kerr,
                                      crosskerr=[], Jkl=jkl, rotfreq=rot)
    kw = dict(T=100.0, Hsys=Hsys, Hc_re=Hc_re, Hc_im=Hc_im,
              maxctrl_MHz=[30.0] * len(Ne), Pmin=150)
    assert tres.estimate_timesteps(**kw) == jres.estimate_timesteps(**kw)
    rk = dict(Ne=Ne, Ng=Ng, Hsys=np.asarray(Hsys), Hc_re=Hc_re, Hc_im=Hc_im,
              rotfreq=rot, cw_amp_thres=1e-7, cw_prox_thres=1e-2)
    ot, gt = tres.get_resonances(**rk)
    oj, gj = jres.get_resonances(**rk)
    for a, b in zip(ot + gt, oj + gj):
        assert np.array_equal(a, b)


# ---- 2. the native library ----

@pytest.mark.parametrize("seed,n", [(1234, 64), (0, 7), (4321, 1000)])
def test_mt19937_bits_equal(seed, n):
    jn, tn = _native_pair()
    assert np.array_equal(tn.mt19937_uniform(seed, n),
                          jn.mt19937_uniform(seed, n))


def test_native_library_built_beside_the_port():
    """The port builds its own copy into build/quandary_tpu_torch/ and
    never writes beside native/quandary_native.cpp."""
    _native_pair()
    path = tnative.library_path()
    assert os.path.exists(path)
    assert os.sep + os.path.join("build", "quandary_tpu_torch") + os.sep \
        in path


def test_read_triplets_and_table_equal(tmp_path):
    jn, tn = _native_pair()
    rng = np.random.default_rng(3)
    hs = tmp_path / "hsys.dat"
    hc = tmp_path / "hc.dat"
    with open(hs, "w") as f:
        f.write("# row col re im\n")
        for i, j in rng.integers(0, 9, (30, 2)):
            f.write(f"{i} {j} {rng.normal():.13e} {rng.normal():.13e}\n")
    with open(hc, "w") as f:
        for k, i, j in rng.integers(0, 3, (20, 3)):
            f.write(f"{k} {i} {j} {rng.normal():.13e} {rng.normal():.13e}\n")
    for path, ncol in ((hs, 2), (hc, 3)):
        it, vt = tn.read_triplets(str(path), ncol)
        ij, vj = jn.read_triplets(str(path), ncol)
        assert np.array_equal(it, ij) and np.array_equal(vt, vj)
    tab = tmp_path / "t.dat"
    tab.write_text("# c\n" + "\n".join(
        " ".join(f"{v:.17g}" for v in row) for row in rng.normal(size=(5, 3))))
    assert np.array_equal(tn.read_table(str(tab), 100),
                          jn.read_table(str(tab), 100))


def test_write_state_rows_same_bytes(tmp_path):
    jn, tn = _native_pair()
    rng = np.random.default_rng(4)
    ts, data = np.arange(7) * 0.125, rng.normal(size=(7, 9))
    for decim in (1, 3):
        a, b = tmp_path / f"t{decim}.dat", tmp_path / f"j{decim}.dat"
        assert tn.write_state_rows(str(a), "", ts, data, decim)
        assert jn.write_state_rows(str(b), "", ts, data, decim)
        _same_bytes(a, b)


# ---- 3. datafiles ----

def test_datafiles_round_trips_and_bytes(tmp_path):
    rng = np.random.default_rng(5)
    vec = rng.normal(size=11)
    state = rng.normal(size=4) + 1j * rng.normal(size=4)
    mat = rng.normal(size=(3, 3)) + 1j * rng.normal(size=(3, 3))
    H = np.where(rng.random((4, 4)) < 0.5, 0, rng.normal(size=(4, 4))
                 + 1j * rng.normal(size=(4, 4)))
    Hc_re = [rng.normal(size=(4, 4)) for _ in range(2)]
    Hc_im = [np.zeros((4, 4)), rng.normal(size=(4, 4))]
    for mod, d in ((tdata, "t"), (jdata, "j")):
        (tmp_path / d).mkdir()
        mod.write_vector(str(tmp_path / d / "v.dat"), vec)
        mod.write_complex_state(str(tmp_path / d / "s.dat"), state)
        mod.write_complex_state(str(tmp_path / d / "m.dat"), mat)
        mod.write_hamiltonian_sys(str(tmp_path / d / "hs.dat"), H)
        mod.write_hamiltonian_ctrl(str(tmp_path / d / "hc.dat"), Hc_re, Hc_im)
    for name in ("v.dat", "s.dat", "m.dat", "hs.dat", "hc.dat"):
        _same_bytes(tmp_path / "t" / name, tmp_path / "j" / name)
    t = tmp_path / "t"
    np.testing.assert_allclose(tdata.read_vector(str(t / "v.dat")), vec,
                               rtol=1e-12)
    np.testing.assert_allclose(
        tdata.read_complex_state(str(t / "s.dat"), 4, False), state,
        rtol=1e-12)
    np.testing.assert_allclose(
        tdata.read_complex_state(str(t / "m.dat"), 3, True), mat, rtol=1e-12)
    np.testing.assert_allclose(tdata.read_hamiltonian_sys(str(t / "hs.dat"), 4),
                               H, rtol=1e-12)
    re, im = tdata.read_hamiltonian_ctrl(str(t / "hc.dat"), 4, 2)
    for a, b in zip(re + im, Hc_re + Hc_im):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=0)


# ---- 4. the trajectory writers ----

@pytest.mark.parametrize("freq", [1, 2])
def test_trajectory_writers_same_bytes(tmp_path, freq):
    rng = np.random.default_rng(6)
    ts = np.arange(9) * 0.25
    vals = rng.normal(size=9)
    pops = rng.random((9, 3))
    psi = rng.normal(size=(9, 4)) + 1j * rng.normal(size=(9, 4))
    rho = rng.normal(size=(9, 3, 3)) + 1j * rng.normal(size=(9, 3, 3))
    entries = sorted({"nlevels": "2, 2", "runtype": "simulation",
                      "dt": "0.1"}.items())
    for mod, d in ((tout, "t"), (jout, "j")):
        dd = str(tmp_path / d)
        os.makedirs(dd)
        for comp in (False, True):
            mod.write_expected_energy(dd, 1, 3, ts, vals, freq, composite=comp)
            mod.write_population(dd, 0, 12, ts, pops, freq, composite=comp)
        mod.write_fullstate(dd, 2, ts, psi, False, freq)
        mod.write_fullstate(dd, 5, ts, rho, True, freq)
        mod.write_config_log(os.path.join(dd, "config_log.dat"), entries)
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t")) and len(names) == 9
    for name in names:
        _same_bytes(tmp_path / "t" / name, tmp_path / "j" / name)
    # tensors write the same files as arrays
    dd = str(tmp_path / "tensors")
    os.makedirs(dd)
    tout.write_population(dd, 0, 12, torch.as_tensor(ts),
                          torch.as_tensor(pops), freq)
    _same_bytes(os.path.join(dd, "population0.iinit0012.dat"),
                tmp_path / "j" / "population0.iinit0012.dat")


# ---- 5. config files ----

BASE = """
nlevels = 3
nessential = 2
ntime = 20
dt = 0.1
transfreq = 4.1
rotfreq = 4.1
selfkerr = 0.22
carrier_frequency0 = 0.0
control_segments0 = spline, 5
control_initialization0 = constant, 0.001
initialcondition = basis
optim_target = pure, 0
runtype = simulation
"""

CONFIGS = {
    "template": None,
    "base": BASE,
    "gmres_matfree": BASE + "linearsolver_type = gmres\nusematfree = true\n",
    "regul_alias": BASE + "optim_regul_interpolate = true\n",
    "random_two_carriers": BASE.replace(
        "carrier_frequency0 = 0.0", "carrier_frequency0 = 0.0, 0.1").replace(
        "control_initialization0 = constant, 0.001",
        "control_initialization0 = random, 0.01")
    + "rand_seed = 77\ncontrol_enforceBC = false\n",
    "open_diagonal": BASE.replace("initialcondition = basis",
                                  "initialcondition = diagonal")
    + "collapse_type = both\ndecay_time = 30.0\ndephase_time = 20.0\n",
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_setup_from_config_equal(tmp_path, name):
    from quandary_tpu.io.configfile import Config as JConfig
    from quandary_tpu.io.configfile import setup_from_config as jsetup
    from quandary_tpu.problem import Problem as JProblem
    from quandary_tpu_torch.io.configfile import Config as TConfig
    from quandary_tpu_torch.io.configfile import setup_from_config as tsetup
    from quandary_tpu_torch.problem import Problem as TProblem
    text = CONFIGS[name]
    if text is None:
        with open(os.path.join(ROOT, "config_template.cfg")) as f:
            text = f.read()
    p = tmp_path / "c.cfg"
    p.write_text(text)
    sj, rj = jsetup(JConfig.read(str(p)), str(tmp_path))
    st, rt = tsetup(TConfig.read(str(p)), str(tmp_path))
    assert st.fused == "auto" and st.dtype == torch.complex128
    assert np.array_equal(st.model.stack, np.asarray(sj.model.stack))
    assert len(st.model.collapse_ops) == len(sj.model.collapse_ops)
    for a, b in zip(st.model.collapse_ops, sj.model.collapse_ops):
        assert np.array_equal(a, np.asarray(b))
    assert [dataclasses.asdict(o) for o in st.oscillators] == \
        [dataclasses.asdict(o) for o in sj.oscillators]
    for f in ("nessential", "ntime", "dt", "timestepper", "linsolve_iters",
              "linsolver", "pipulses", "ground_freqs_radns", "initcond_type",
              "initcond_ids", "pure_levels", "target_type",
              "pure_target_levels", "objective_type", "gamma_tik",
              "gamma_tik_interpolate", "gamma_penalty", "penalty_param",
              "gamma_penalty_dpdm", "gamma_penalty_energy",
              "gamma_penalty_variation"):
        assert getattr(st, f) == getattr(sj, f), f
    for f in ("target_gate_full", "target_state_full", "obj_weights"):
        a, b = getattr(st, f), getattr(sj, f)
        assert (a is None and b is None) or np.array_equal(a, b), f
    assert dataclasses.asdict(rt).keys() == dataclasses.asdict(rj).keys()
    for f in dataclasses.fields(rj):
        a, b = getattr(rt, f.name), getattr(rj, f.name)
        if f.name == "params0":
            assert np.array_equal(a, b)
        else:
            assert a == b, f.name
    pt = TProblem(st, device="cpu")
    pj = JProblem(sj)
    assert np.array_equal(pt.x0, np.asarray(pj.x0))
    assert list(pt.initids) == list(pj.initids)
    assert pt.fused_form is None and not pt.use_fused
    if pj.target is not None:
        assert np.array_equal(pt.target, np.asarray(pj.target))


BIG = """
nlevels = 33, 32
nessential = 2, 2
ntime = 3
dt = 0.05
transfreq = 4.1, 4.2
rotfreq = 4.1, 4.2
selfkerr = 0.22, 0.21
crosskerr = 0.001
Jkl = 0.002
carrier_frequency0 = 0.0
carrier_frequency1 = 0.0
control_segments0 = spline, 5
control_segments1 = spline, 5
control_initialization0 = constant, 0.01
control_initialization1 = constant, 0.01
initialcondition = basis
optim_target = pure, 0, 0
runtype = simulation
"""


def test_large_standard_model_refused(tmp_path):
    """Past N = 1024 (here 33 x 32) the config builds the reference's
    StructuredModel, field for field, and a 3-step simulate matches the
    JAX Problem's (the tensor engine; J and every aux term to 1e-10)."""
    import jax.numpy as jnp
    from quandary_tpu.io.configfile import Config as JConfig
    from quandary_tpu.io.configfile import setup_from_config as jsetup
    from quandary_tpu.problem import Problem as JProblem
    from quandary_tpu_torch.io.configfile import Config, setup_from_config
    from quandary_tpu_torch.ops.tensor_rhs import StructuredModel
    from quandary_tpu_torch.problem import Problem as TProblem
    p = tmp_path / "big.cfg"
    p.write_text(BIG)
    st, rt = setup_from_config(Config.read(str(p)), str(tmp_path))
    sj, rj = jsetup(JConfig.read(str(p)), str(tmp_path))
    assert isinstance(st.model, StructuredModel) and st.model.N == 1056
    assert dataclasses.asdict(st.model) == dataclasses.asdict(sj.model)
    pt, pj = TProblem(st, device="cpu"), JProblem(sj)
    assert type(pt.engine).__name__ == type(pj.engine).__name__ \
        == "TensorEngine"
    Jt, auxt = pt.build_objective()(rt.params0, rt.params0)
    x = jnp.asarray(rj.params0)
    Jj, auxj = pj.objective(x, x)
    np.testing.assert_allclose(float(Jt), float(Jj), rtol=1e-10)
    for k in auxj:
        np.testing.assert_allclose(float(auxt[k]), float(auxj[k]),
                                   rtol=1e-10, atol=1e-14, err_msg=k)


# ---- 6. steppers ----

def _engines(lindblad, dtype=torch.complex128):
    from quandary_tpu.models.hamiltonian import build_standard_model as jb
    from quandary_tpu.ops.rhs import DenseEngine as JE
    from quandary_tpu_torch.models.hamiltonian import \
        build_standard_model as tb
    from quandary_tpu_torch.ops.rhs import DenseEngine as TE
    kw = dict(nlevels=[3, 2], freq01_ghz=[4.1, 4.3], rotfreq_ghz=[4.1, 4.3],
              selfkerr_ghz=[0.22, 0.2], crosskerr_ghz=[], jkl_ghz=[0.005])
    if lindblad:
        kw.update(decay_time=[30.0, 40.0], dephase_time=[20.0, 25.0],
                  lindblad=True)
    return (JE(jb(**kw), dtype=jnp.complex128),
            TE(tb(**kw), dtype, "cpu"))


def _state(N, lindblad, rng, B=3):
    if lindblad:
        x = rng.normal(size=(B, N, N)) + 1j * rng.normal(size=(B, N, N))
        return x + x.conj().transpose(0, 2, 1)
    return rng.normal(size=(B, N)) + 1j * rng.normal(size=(B, N))


@pytest.mark.parametrize("lindblad", [False, True])
@pytest.mark.parametrize("stepper,solver", [
    ("IMR4", "neumann"), ("IMR8", "jacobi"), ("EE", "neumann"),
    ("IMR", "gmres"), ("IMR4", "split")])
def test_step_equal_to_jax(stepper, solver, lindblad):
    from quandary_tpu.ops.steppers import make_step_fn as jstep
    from quandary_tpu.ops.steppers import stage_midpoint_times as jmid
    from quandary_tpu_torch.ops.steppers import make_step_fn as tstep
    from quandary_tpu_torch.ops.steppers import stage_midpoint_times as tmid
    je, te = _engines(lindblad)
    rng = np.random.default_rng(7)
    dt, iters = 0.05, 6
    assert np.array_equal(tmid(10, dt, stepper), jmid(10, dt, stepper))
    nst = tmid(1, dt, stepper).shape[1]
    c = rng.normal(size=(nst, te.model.K)) * 0.05
    c[:, 0] = 1.0
    x = _state(te.N, lindblad, rng)
    gj, gt = je.gen_diag(), te.gen_diag()
    want = np.asarray(jstep(je.rhs, dt, stepper, iters, solver, gen_diag=gj)(
        jnp.asarray(x), jnp.asarray(c)))
    for engine in (None, te):
        got = tstep(te.rhs, dt, stepper, iters, solver, gen_diag=gt,
                    engine=engine)(torch.as_tensor(x), torch.as_tensor(c))
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-12 * np.abs(want).max())


def test_gmres_per_candidate():
    """With vec_ndim, leading axes are independent systems: a batch of two
    candidates gives each candidate's own one-system solve."""
    from quandary_tpu_torch.ops.steppers import make_step_fn
    _, te = _engines(False)
    rng = np.random.default_rng(8)
    c = rng.normal(size=(2, 1, te.model.K)) * 0.05
    x = np.stack([_state(te.N, False, rng), _state(te.N, False, rng)])
    step = make_step_fn(te.rhs, 0.05, "IMR", 6, "gmres", vec_ndim=2)
    both = step(torch.as_tensor(x), torch.as_tensor(c))
    for e in range(2):
        one = step(torch.as_tensor(x[e]), torch.as_tensor(c[e]))
        np.testing.assert_allclose(both[e].numpy(), one.numpy(), rtol=0,
                                   atol=1e-13)


def _step_copying_every_call(rhs, dt, iters, linsolver, gen_diag):
    """The IMR step as the port had it before its device constants were
    hoisted: the diagonal and the split factors copied from the host in
    every call."""
    from quandary_tpu_torch.ops.steppers import (jacobi_neumann_solve,
                                                 neumann_solve)
    d64 = np.asarray(gen_diag, np.complex128)

    def step(x, c_stages):
        d = torch.as_tensor(d64, device=x.device).to(x.dtype)
        h = float(dt)
        c = c_stages[..., 0, :]
        if linsolver == "split":
            E = torch.as_tensor(np.exp((h / 2.0) * d64),
                                device=x.device).to(x.dtype)
            mv = lambda y: rhs(c, y) - d * y
            x = E * x
            k = neumann_solve(mv, mv(x), h / 2.0, iters)
            return E * (x + h * k)
        mv = lambda y: rhs(c, y)
        b = mv(x)
        if linsolver == "jacobi":
            k = jacobi_neumann_solve(mv, d, b, h / 2.0, iters)
        else:
            k = neumann_solve(mv, b, h / 2.0, iters)
        return x + h * k
    return step


@pytest.mark.parametrize("lindblad", [False, True])
@pytest.mark.parametrize("solver", ["neumann", "jacobi", "split"])
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_step_bits_unchanged(solver, lindblad, dtype):
    """The step with its constants built once per device (and, given the
    engine, H_eff assembled once per stage and the stage solve as one
    autograd node) has the bits of the step that copied them in every
    call, over ten steps."""
    from quandary_tpu_torch.ops.steppers import make_step_fn
    _, te = _engines(lindblad, dtype)
    rng = np.random.default_rng(9)
    dt, iters = 0.05, 5
    gd = te.gen_diag()
    old = _step_copying_every_call(te.rhs, dt, iters, solver, gd)
    news = [make_step_fn(te.rhs, dt, "IMR", iters, solver, gen_diag=gd,
                         engine=e) for e in (None, te)]
    C = torch.as_tensor(rng.normal(size=(10, 1, te.model.K)) * 0.05)
    x0 = torch.as_tensor(_state(te.N, lindblad, rng)).to(dtype)
    xo, xs = x0, [x0, x0]
    for n in range(10):
        xo = old(xo, C[n])
        xs = [f(x, C[n]) for f, x in zip(news, xs)]
        for x in xs:
            assert torch.equal(x, xo)


@pytest.mark.parametrize("lindblad", [False, True])
@pytest.mark.parametrize("solver", ["neumann", "jacobi", "split"])
def test_stage_solve_transpose_matches_autograd(solver, lindblad):
    """The stage solves' hand-written transpose (engine given) against
    autograd through every operation of the unrolled iterations (no
    engine): the gradient of a real functional of three steps with respect
    to the coefficient rows and the initial state."""
    from quandary_tpu_torch.ops.steppers import make_step_fn
    _, te = _engines(lindblad)
    rng = np.random.default_rng(10)
    gd = te.gen_diag()
    C = rng.normal(size=(3, 2, 1, te.model.K)) * 0.05
    x0 = _state(te.N, lindblad, rng)
    w = torch.as_tensor(_state(te.N, lindblad, rng))
    grads = []
    for engine in (None, te):
        step = make_step_fn(te.rhs, 0.05, "IMR", 4, solver, gen_diag=gd,
                            engine=engine)
        c = torch.as_tensor(C).requires_grad_(True)
        x = torch.as_tensor(x0).requires_grad_(True)
        y = x
        for n in range(3):
            y = step(y, c[n])
        loss = torch.sum((w.conj() * y).real * (y.abs() ** 2))
        grads.append(torch.autograd.grad(loss, (c, x)))
    for a, b in zip(*grads):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0,
                                   atol=1e-12 * float(a.abs().max()))


# ---- 7. observables ----

@pytest.mark.parametrize("dims", [(3,), (2, 3), (2, 3, 2)])
def test_observables_equal(dims):
    from quandary_tpu.ops import solvers as js
    from quandary_tpu_torch.ops import solvers as ts
    rng = np.random.default_rng(11)
    pop = rng.random((5, 4, int(np.prod(dims))))
    for k in range(len(dims)):
        np.testing.assert_allclose(
            ts.reduced_population(torch.as_tensor(pop), dims, k).numpy(),
            np.asarray(js.reduced_population(jnp.asarray(pop), dims, k)),
            rtol=1e-14)
        np.testing.assert_allclose(
            ts.expected_energy(torch.as_tensor(pop), dims, k).numpy(),
            np.asarray(js.expected_energy(jnp.asarray(pop), dims, k)),
            rtol=1e-14)
    np.testing.assert_allclose(
        ts.expected_energy_composite(torch.as_tensor(pop), dims).numpy(),
        np.asarray(js.expected_energy_composite(jnp.asarray(pop), dims)),
        rtol=1e-14)
