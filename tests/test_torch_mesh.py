"""quandary_tpu_torch's multi-device layer (parallel/mesh.py,
parallel/multihost.py) on the CPU: one spawned group of 4 gloo ranks, the
counterpart of tests/test_multihost.py's, runs

* the 'init' axis (shard_problem) on make_mesh(4, 1) and make_mesh(2, 2)
  (replicas along 'hilbert') for __graft_entry__._build_problem(ntime=12,
  T=2.0, complex128), Lindblad and closed, carried across with
  test_torch_model.port_setup, and for the closed problem on the other
  routes Problem takes (the plain loop, the time-parallel scan, the
  reversible adjoint, the variation penalty) and on the structured
  engines (tensor; grouped with its hand-written adjoint), open systems
  also on the rho route;
* the candidate axis: the ensemble value_and_grad and the sweeps at E = 16,
  R = 2 (the closed problem in complex64 on the fused route's plain
  version), on both meshes; a population optimization (batched_lbfgsb
  over packed_batch_fns(mesh=...), E = 16, 6 iterations, history 4);
* sync_global_value, and the ValueErrors of a batch or an ensemble that
  the axis does not divide.

The parent holds the workers' results against the JAX package's own
sharded results on its virtual mesh, built as tests/test_sharding.py
builds them, within the reference's tolerances (objective: J 1e-10 abs,
gradient rtol 1e-8 / atol 1e-12; ensemble: rtol 1e-6, gradient rtol 1e-5 /
atol 1e-7; population: rtol 2e-5, against the JAX population on its XLA
path, whose sharded run test_sharding.py holds to the unsharded one at the
same bound); against the unsharded port (J 1e-12 abs, gradient rtol 1e-10
/ atol 1e-14 in f64; the ensemble's f32 J and gradient rtol 1e-6 / 1e-5);
and against each other: every rank's results are the same bits. The state
part of the gradient and the Tikhonov, energy and variation terms each
count once at n_init = 2 and 4: the sharded gradient equals the unsharded
one, and a term counted n_init times would not.

In-process: initialize() from torchrun's environment variables on a
one-rank group, where the sharded objective is the unsharded one's bits,
and shard_hilbert=True raising NotImplementedError."""

import dataclasses
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_model import arrays_from_jax_setup  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
MESHES = ((4, 1), (2, 2))
E, R = 16, 2
POP_ITERS, POP_HISTORY = 6, 4

WORKER = r"""
import os, pickle, sys
os.environ["OMP_NUM_THREADS"] = "1"
rank, port, cases_path, out_path = (int(sys.argv[1]), sys.argv[2],
                                    sys.argv[3], sys.argv[4])
sys.path.insert(0, {repo!r})
import dataclasses
import numpy as np
import torch
torch.set_num_threads(1)
from quandary_tpu_torch.convert import setup_from_arrays
from quandary_tpu_torch.ops.hostloop import HostLoopRunner
from quandary_tpu_torch.optim import robust
from quandary_tpu_torch.optim.batched_lbfgs import batched_lbfgsb
from quandary_tpu_torch.optim.hessian import hessian
from quandary_tpu_torch.parallel import mesh as mesh_mod, multihost
from quandary_tpu_torch.problem import Problem

device = multihost.initialize(coordinator_address=f"localhost:{{port}}",
                              num_processes={world}, process_id=rank)
with open(cases_path, "rb") as f:
    job = pickle.load(f)
meshes = {{shape: mesh_mod.make_mesh(*shape, device="cpu")
          for shape in job["meshes"]}}
out = dict(device=str(device), multihost=multihost.is_multihost())

def problem(name):
    arrays, overrides = job["cases"][name]
    return Problem(dataclasses.replace(setup_from_arrays(arrays),
                                       **overrides), device="cpu")

def vg_np(prob, x):
    (J, aux), g = prob.build_value_and_grad()(x, x)
    return dict(J=J.numpy(), g=g.numpy(),
                **{{k: v.numpy() for k, v in aux.items()}})

# the 'init' axis, every case on both meshes
for name in job["init_cases"]:
    for shape, m in meshes.items():
        prob = mesh_mod.shard_problem(problem(name), m)
        out[("init", name, shape)] = dict(
            vg_np(prob, job["params"][name]), ninit=prob.ninit,
            route=prob.fused_form, tp=prob.time_parallel,
            adjoint=prob.adjoint_route)

# the packed robust objective over sharded samples, on both meshes
x = torch.as_tensor(job["params"]["closed"])
for shape, m in meshes.items():
    samples = [mesh_mod.shard_problem(problem(n), m)
               for n in ("closed", "closed_detuned")]
    xg = x.clone().requires_grad_(True)
    J, aux = robust.build_packed_robust_objective(samples, job["robust_w"])(
        xg, x)
    (g,) = torch.autograd.grad(J, xg)
    out[("robust", shape)] = dict(J=J.detach().numpy(), g=g.numpy())

# the candidate axis, on 'init' of both meshes and on 'hilbert' of (2, 2)
ens = problem("ensemble")
Ps, ref = job["Ps"], job["ref"]
for (shape, m), axis in [(kv, "init") for kv in meshes.items()] + [
        (((2, 2), meshes[(2, 2)]), "hilbert")]:
    (J, aux), g = ens.build_ensemble_value_and_grad(mesh=m, axis=axis)(
        Ps[0], ref)
    out[("ensemble", shape) if axis == "init" else ("ensemble", axis)] = dict(
        J=J.numpy(), g=g.numpy(), fidelity=aux["fidelity"].numpy(),
        sweeps=ens.build_ensemble_sweeps(mesh=m, axis=axis)(Ps, ref).numpy())
pop = batched_lbfgsb(None, None, torch.as_tensor(job["x0s"]), job["lb"],
                     job["ub"], iters={iters}, history={history},
                     **ens.packed_batch_fns(ref, mesh=meshes[(4, 1)]))
out["population"] = [t.numpy() for t in pop]

out["sync"] = (multihost.sync_global_value(float(rank) + 0.5),
               multihost.sync_global_value(torch.full((2,), float(rank)))
               .numpy())

# what raises
def error(fn):
    try:
        fn()
    except Exception as e:
        return type(e).__name__, str(e)
    return None

loop = mesh_mod.shard_problem(problem("closed_loop"), meshes[(4, 1)])
xl = torch.as_tensor(job["params"]["closed_loop"])
out["errors"] = dict(
    hessian=error(lambda: hessian(loop, xl)),
    double_backward=error(lambda: torch.autograd.functional.hessian(
        lambda v: loop.objective(v, xl)[0], xl)),
    hostloop=error(lambda: HostLoopRunner(loop).gradient(
        xl, lambda xT, p: (xT.abs() ** 2).sum())),
    batch=error(lambda: mesh_mod.shard_problem(problem("batch2"),
                                               meshes[(4, 1)])),
    ensemble=error(lambda: ens.build_ensemble_value_and_grad(
        mesh=meshes[(4, 1)])(Ps[0, :6], ref)),
    both_axes=error(lambda: mesh_mod.shard_problem(
        problem("closed"), meshes[(4, 1)]).build_ensemble_value_and_grad(
            mesh=meshes[(4, 1)])))
out["jax_imported"] = "jax" in sys.modules
np.save(out_path, out, allow_pickle=True)
torch.distributed.destroy_process_group()
"""


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _jax_problem(lindblad=False, dtype=jnp.complex128, **kw):
    from __graft_entry__ import _build_problem
    return _build_problem(ntime=12, T=2.0, lindblad=lindblad, dtype=dtype,
                          **kw)


def _jobs():
    """The cases (plain data of each JAX Setup and the port's overrides),
    their parameters and the candidate axis' inputs, as the workers get
    them."""
    from __graft_entry__ import _build_grouped_problem
    _, s_lind = _jax_problem(lindblad=True)
    _, s_closed = _jax_problem()
    _, s_ens = _jax_problem(dtype=jnp.complex64)
    _, s_grp = _build_grouped_problem(nlev=4, ntime=8, T=0.8,
                                      dtype=jnp.complex128, linsolve_iters=4)
    plain = dict(fused=False, time_parallel=False)
    cases = {
        "lindblad": (s_lind, {}),
        "lindblad_rho": (s_lind, dict(fused_rho="rho")),
        "closed": (s_closed, {}),
        "closed_variation": (s_closed, dict(gamma_penalty_variation=0.1)),
        "closed_scan": (s_closed, dict(fused=False)),
        "closed_loop": (s_closed, plain),
        "closed_reversible": (s_closed, dict(
            plain, adjoint="reversible", gamma_penalty_dpdm=0.0)),
        "tensor": (s_grp, dict(fused="auto", engine="tensor")),
        "grouped": (s_grp, dict(fused="auto", engine="grouped")),
        "ensemble": (s_ens, {}),
        "batch2": (s_closed, dict(initcond_ids=(0,))),
    }
    job = dict(
        cases={k: (arrays_from_jax_setup(s), dict({"fused": True}, **o))
               for k, (s, o) in cases.items()},
        robust_w=[0.6, 0.4],
        init_cases=[k for k in cases if k not in ("ensemble", "batch2")],
        meshes=MESHES,
        params={k: np.random.default_rng(0).normal(size=s.nparams) * 0.02
                for k, (s, _) in cases.items()})
    # a second sample of the closed problem for the packed robust
    # objective: its drift's diagonal 1% larger
    arrays = dict(job["cases"]["closed"][0])
    stack = arrays["stack"].copy()
    stack[0] += 0.01 * np.diag(np.diagonal(stack[0]))
    arrays["stack"] = stack
    job["cases"]["closed_detuned"] = (arrays, job["cases"]["closed"][1])
    n = s_ens.nparams
    rng = np.random.default_rng(7)
    job.update(Ps=(rng.normal(size=(R, E, n)) * 0.02).astype(np.float32),
               ref=np.zeros(n, np.float32),
               x0s=(np.random.default_rng(11).normal(size=(E, n))
                    * 0.02).astype(np.float32),
               lb=-0.5 * np.ones(n, np.float32),
               ub=0.5 * np.ones(n, np.float32))
    return job, cases


def _jax_references(job, cases):
    """The JAX package's sharded results on its virtual 8-device mesh (as
    tests/test_sharding.py:15 and :92 build them; 'hilbert' sharded where
    the mesh has it), and its unsharded population on the XLA path."""
    import dataclasses as dc

    from quandary_tpu.optim.batched_lbfgs import batched_lbfgsb as jbatched
    from quandary_tpu.parallel.mesh import make_mesh, shard_problem
    from quandary_tpu.problem import Problem as JProblem

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual devices of tests/conftest.py")
    refs = {}
    for name in ("lindblad", "closed"):
        x = jnp.asarray(job["params"][name])
        for ni, nh in MESHES:
            prob = JProblem(cases[name][0])
            mesh = make_mesh(ni, nh)
            shard_problem(prob, mesh, shard_hilbert=nh > 1)
            with mesh:
                (J, _), g = jax.jit(jax.value_and_grad(
                    prob.objective, has_aux=True))(x, x)
            refs[("init", name, (ni, nh))] = (float(J), np.asarray(g))
    prob = JProblem(dc.replace(cases["ensemble"][0]))
    Ps, ref = jnp.asarray(job["Ps"]), jnp.asarray(job["ref"])
    for key, (ni, nh), axis in [(("ensemble", s), s, "init")
                                for s in MESHES] + [
            (("ensemble", "hilbert"), (2, 2), "hilbert")]:
        mesh = make_mesh(ni, nh)
        with mesh:
            sw = prob.build_ensemble_sweeps(mesh=mesh, axis=axis)(Ps, ref)
            (J, _), g = prob.build_ensemble_value_and_grad(
                mesh=mesh, axis=axis)(Ps[0], ref)
        refs[key] = (np.asarray(J), np.asarray(g), float(sw))

    def objective(x):
        return prob.objective(x, ref)[0]

    run = prob._wrap_with_data(lambda xs: jbatched(
        objective, jax.grad(objective), xs, job["lb"], job["ub"],
        iters=POP_ITERS, history=POP_HISTORY))
    refs["population"] = [np.asarray(t) for t in run(jnp.asarray(job["x0s"]))]
    return refs


def _unsharded(job):
    """The port's unsharded results of every case on one process."""
    from quandary_tpu_torch.convert import setup_from_arrays
    from quandary_tpu_torch.optim.batched_lbfgs import batched_lbfgsb
    from quandary_tpu_torch.problem import Problem

    def problem(name):
        arrays, overrides = job["cases"][name]
        return Problem(dataclasses.replace(setup_from_arrays(arrays),
                                           **overrides), device="cpu")
    out = {}
    for name in job["init_cases"]:
        x = job["params"][name]
        (J, aux), g = problem(name).build_value_and_grad()(x, x)
        out[name] = dict(J=J.numpy(), g=g.numpy(),
                         **{k: v.numpy() for k, v in aux.items()})
    from quandary_tpu_torch.optim import robust
    x = torch.as_tensor(job["params"]["closed"]).requires_grad_(True)
    J, _ = robust.build_packed_robust_objective(
        [problem("closed"), problem("closed_detuned")], job["robust_w"])(
            x, x.detach())
    (g,) = torch.autograd.grad(J, x)
    out["robust"] = dict(J=J.detach().numpy(), g=g.numpy())
    ens = problem("ensemble")
    (J, _), g = ens.build_ensemble_value_and_grad()(job["Ps"][0], job["ref"])
    out["ensemble"] = (J.numpy(), g.numpy(), float(
        ens.build_ensemble_sweeps()(job["Ps"], job["ref"])))
    pop = batched_lbfgsb(None, None, torch.as_tensor(job["x0s"]), job["lb"],
                         job["ub"], iters=POP_ITERS, history=POP_HISTORY,
                         **ens.packed_batch_fns(job["ref"]))
    out["population"] = [t.numpy() for t in pop]
    return out


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Runs the 4 ranks (started first, so that the JAX references and the
    unsharded port are computed while they run) and returns (each rank's
    results, the JAX references, the unsharded port's)."""
    tmp = tmp_path_factory.mktemp("mesh")
    job, cases = _jobs()
    cases_path = tmp / "cases.pkl"
    with open(cases_path, "wb") as f:
        pickle.dump(job, f)
    script = tmp / "worker.py"
    script.write_text(WORKER.format(repo=REPO, world=WORLD, iters=POP_ITERS,
                                    history=POP_HISTORY))
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env.update(OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(port), str(cases_path),
         str(tmp / f"rank{r}.npy")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env) for r in range(WORLD)]
    try:
        refs = _jax_references(job, cases)
        unsharded = _unsharded(job)
        for p in procs:
            log, _ = p.communicate(timeout=300)
            assert p.returncode == 0, log[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ranks = [np.load(tmp / f"rank{r}.npy", allow_pickle=True).item()
             for r in range(WORLD)]
    return ranks, refs, unsharded, job


def _close(a, b, rtol, atol, what):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol, err_msg=what)


@pytest.mark.parametrize("name", ["lindblad", "closed"])
@pytest.mark.parametrize("shape", MESHES)
def test_init_axis_matches_jax_sharded(group, name, shape):
    ranks, refs, _, _ = group
    J_ref, g_ref = refs[("init", name, shape)]
    got = ranks[0][("init", name, shape)]
    assert got["ninit"] == {"lindblad": 16, "closed": 4}[name] // shape[0]
    assert abs(float(got["J"]) - J_ref) < 1e-10
    _close(got["g"], g_ref, 1e-8, 1e-12, f"{name} {shape}")


@pytest.mark.parametrize("name", [
    "lindblad", "lindblad_rho", "closed", "closed_variation", "closed_scan",
    "closed_loop", "closed_reversible", "tensor", "grouped"])
def test_init_axis_matches_unsharded(group, name):
    """On every route: J, each aux term and the gradient of the sharded
    problem at n_init = 4 and 2 against the unsharded port. The regularizers
    (Tikhonov, energy, variation) are the same bits: computed once on every
    rank, not summed over the ranks."""
    ranks, _, unsharded, _ = group
    ref = unsharded[name]
    routes = {"lindblad_rho": ("rho", False, "stored"),
              "closed_scan": (None, True, "stored"),
              "closed_loop": (None, False, "stored"),
              "closed_reversible": (None, False, "reversible"),
              "tensor": (None, False, "reversible"),
              "grouped": (None, False, "grouped")}
    for shape in MESHES:
        got = ranks[0][("init", name, shape)]
        assert (got["route"], got["tp"], got["adjoint"]) == routes.get(
            name, ("superop" if "lindblad" in name else "streamk", False,
                   "stored")), (name, shape)
        assert abs(float(got["J"]) - float(ref["J"])) < 1e-12
        for k in ("obj_cost", "obj_penal", "obj_penal_dpdm", "fidelity"):
            assert abs(float(got[k]) - float(ref[k])) < 1e-12, k
        for k in ("obj_regul", "obj_penal_energy", "obj_penal_variation"):
            assert float(got[k]) == float(ref[k]), k
        _close(got["g"], ref["g"], 1e-10, 1e-14, f"{name} {shape}")


def test_every_rank_has_the_same_bits(group):
    ranks, _, _, _ = group

    def flat(x):
        if isinstance(x, dict):
            return {k: flat(v) for k, v in x.items()
                    if k not in ("device",)}
        if isinstance(x, (list, tuple)):
            return [flat(v) for v in x]
        return np.asarray(x).tobytes() if isinstance(
            x, (np.ndarray, np.generic)) else x

    keys = [k for k in ranks[0] if k != "sync"]
    for r in range(1, WORLD):
        assert set(ranks[r]) == set(ranks[0])
        for k in keys:
            assert flat(ranks[r][k]) == flat(ranks[0][k]), (r, k)
    assert all(not rk["jax_imported"] for rk in ranks)
    assert all(rk["multihost"] and rk["device"] == "cpu" for rk in ranks)


def test_packed_robust_over_sharded_samples_matches_unsharded(group):
    """The packed robust objective over two samples, each sharded over
    'init' (n_init = 4 and 2): J and the gradient of the unsharded packed
    objective, so the state part of every sample's gradient is summed over
    the ranks (coeff_rows_mid's half of the pair), not one rank's share."""
    ranks, _, unsharded, _ = group
    ref = unsharded["robust"]
    for shape in MESHES:
        got = ranks[0][("robust", shape)]
        assert abs(float(got["J"]) - float(ref["J"])) < 1e-12
        _close(got["g"], ref["g"], 1e-10, 1e-14, f"robust {shape}")


@pytest.mark.parametrize("shape", MESHES + ("hilbert",))
def test_ensemble_matches_jax_sharded_and_unsharded(group, shape):
    """On 'init' of both meshes, and on 'hilbert' of make_mesh(2, 2), where
    the ranks along 'init' compute replicas: the same rows per rank as on
    'init' of that mesh, so the same bits."""
    ranks, refs, unsharded, _ = group
    got = ranks[0][("ensemble", shape)]
    if shape == "hilbert":
        same = ranks[0][("ensemble", (2, 2))]
        assert all(np.array_equal(got[k], same[k]) for k in same)
    J_ref, g_ref, sw_ref = refs[("ensemble", shape)]
    assert got["J"].shape == (E,) and got["g"].shape == g_ref.shape
    _close(got["J"], J_ref, 1e-6, 0, "J against JAX")
    _close(got["g"], g_ref, 1e-5, 1e-7, "gradient against JAX")
    _close(got["sweeps"], sw_ref, 1e-6, 0, "sweeps against JAX")
    J_u, g_u, sw_u = unsharded["ensemble"]
    _close(got["J"], J_u, 1e-6, 0, "J against the unsharded port")
    _close(got["g"], g_u, 1e-5, 1e-7, "gradient against the unsharded port")
    _close(got["sweeps"], sw_u, 1e-6, 0, "sweeps against the unsharded port")


def test_population_matches_jax_and_unsharded(group):
    ranks, refs, unsharded, _ = group
    x, f, tr = ranks[0]["population"]
    assert tr.shape == (POP_ITERS + 1, E)
    for name, (xr, fr, trr) in (("JAX", refs["population"]),
                                ("the unsharded port",
                                 unsharded["population"])):
        _close(tr, trr, 2e-5, 1e-8, f"trace against {name}")
        _close(f, fr, 2e-5, 1e-8, f"f_best against {name}")
    # the candidates: test_sharding.py's bound against the unsharded port;
    # against JAX's f32 steps (another implementation, gradients 1e-5 x
    # max apart) 1e-4 x max |x|
    _close(x, unsharded["population"][0], 1e-4, 1e-7, "x_best")
    xj = refs["population"][0]
    assert np.abs(x - xj).max() <= 1e-4 * np.abs(xj).max()


def test_sync_global_value_is_rank_0s(group):
    ranks, _, _, _ = group
    for rk in ranks:
        value, tensor = rk["sync"]
        assert value == 0.5 and isinstance(value, float)
        assert np.array_equal(tensor, np.zeros(2, np.float32))


def test_what_the_axis_does_not_divide_raises(group):
    ranks, _, _, _ = group
    for rk in ranks:
        errs = rk["errors"]
        assert errs["batch"][0] == "ValueError"
        assert "2 not divisible by mesh axis 'init' of size 4" \
            in errs["batch"][1]
        assert errs["ensemble"] == (
            "ValueError",
            "ensemble size E 6 not divisible by mesh axis 'init' of size 4")
        assert errs["both_axes"][0] == "NotImplementedError"
        assert "C4 item 15" in errs["both_axes"][1]
        # what a sharded problem refuses: the second derivative through
        # the pair of collectives, and the host loop's gradient
        assert errs["hessian"][0] == "NotImplementedError"
        assert "C4 item 16" in errs["hessian"][1]
        assert errs["double_backward"][0] == "RuntimeError"
        assert "C4 item 16" in errs["double_backward"][1]
        assert errs["hostloop"][0] == "NotImplementedError"
        assert "C4 item 16" in errs["hostloop"][1]


def test_one_rank_group_from_torchrun_env(monkeypatch):
    """initialize() reads torchrun's variables and makes a one-rank gloo
    group (the reference returns without one, C4 item 14); on it the
    sharded objective is the unsharded one's bits, the mesh refuses more
    ranks than there are, and rank 0's value is every rank's."""
    import torch.distributed as dist

    from quandary_tpu_torch.convert import setup_from_arrays
    from quandary_tpu_torch.parallel import mesh as mesh_mod, multihost
    from quandary_tpu_torch.problem import Problem

    _, sj = _jax_problem()
    setup = dataclasses.replace(
        setup_from_arrays(arrays_from_jax_setup(sj)), fused=True)
    x = np.random.default_rng(0).normal(size=sj.nparams) * 0.02
    (J0, aux0), g0 = Problem(setup, device="cpu").build_value_and_grad()(x, x)

    for k, v in dict(MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
                     RANK="0", WORLD_SIZE="1").items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="initialize"):
        mesh_mod.make_mesh(1, 1, device="cpu")
    assert multihost.sync_global_value(2.5) == 2.5
    device = multihost.initialize()
    try:
        assert device == torch.device("cpu") and dist.get_world_size() == 1
        assert dist.get_backend() == "gloo" and not multihost.is_multihost()
        with pytest.raises(RuntimeError, match="exists already"):
            multihost.initialize()
        with pytest.raises(ValueError, match="need 2 ranks, have 1"):
            mesh_mod.make_mesh(2, 1, device="cpu")
        m = mesh_mod.make_mesh(1, 1, device="cpu")
        p = mesh_mod.shard_problem(Problem(setup, device="cpu"), m)
        assert p.mesh is m and p.ninit == p.ninit_global == 4
        (J, aux), g = p.build_value_and_grad()(x, x)
        assert torch.equal(J, J0) and torch.equal(g, g0)
        assert all(torch.equal(aux[k], aux0[k]) for k in aux0)
        with pytest.raises(ValueError, match="sharded already"):
            mesh_mod.shard_problem(p, m)
        assert multihost.sync_global_value(np.float64(1.5)) == 1.5
    finally:
        dist.destroy_process_group()


def test_shard_hilbert_raises():
    from quandary_tpu_torch.convert import setup_from_arrays
    from quandary_tpu_torch.parallel import mesh as mesh_mod
    from quandary_tpu_torch.problem import Problem

    _, sj = _jax_problem()
    p = Problem(setup_from_arrays(arrays_from_jax_setup(sj)), device="cpu")
    with pytest.raises(NotImplementedError, match="'hilbert' slice"):
        mesh_mod.shard_problem(p, None, shard_hilbert=True)
    assert p.mesh is None and p.ninit == 4
