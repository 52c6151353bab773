"""Routing under fused='auto' where the port's own limits refuse a problem
the JAX package's gate admits (ROADMAP C2), on the CPU.

The reference falls back to its scan only where its own gate refuses
(quandary_tpu/problem.py:440-499) and runs everywhere else; the port adds
limits of its own: a sweep's device memory past streamk.DEVICE_BUDGET_BYTES
on 'streamk' (closed and superop), the plane budget of 'chunk' and dense
(stream.PLANE_BUDGET_BYTES), rho past N = 128. Problem decides before any
plan or state layout is built, from sizes and budgets alone:
`route_refusal` names the limit, `fused_decision` sends 'auto' to the plain
loop on the same device with that sentence as `fused_refusal`, and
fused=True raises it on CUDA. Here both functions are held with the budgets
patched down, for a closed system (N = 64 SWAP02) and an open one on the
superop route (the unguarded open CNOT at dimension 16), against the
sentence the route's own gate gives on the launch plan a fused=True
Problem builds on the CPU. The card test of the same decision is
tests/test_torch_cuda.py::test_auto_runs_plain_loop_where_the_budget_
refuses_on_card.
"""

import pytest

torch = pytest.importorskip("torch")

from quandary_tpu_torch import problem as tp  # noqa: E402
from quandary_tpu_torch.ops import rho, stream, streamk  # noqa: E402
from quandary_tpu_torch.problem import Problem as TProblem  # noqa: E402
from test_torch_lindblad import unguarded_setup  # noqa: E402
from test_torch_model import port_setup  # noqa: E402
from test_torch_streamk_mid import swap02_setup  # noqa: E402

WHY = ("streamK mid kernels: a sweep's history, cotangents, stored iterates "
       "and scratch take 1 bytes of device memory, past "
       "DEVICE_BUDGET_BYTES = 0")


def test_decision_auto_falls_to_the_plain_loop():
    """'auto' on CUDA: the fused route where the gate and the kernels admit
    the problem, else the plain loop with the refusal as its reason (the
    gate's first); on the CPU the plain loop always; fused=True raises the
    kernels' refusal on CUDA and runs the plain versions on the CPU;
    fused=False is the plain loop."""
    assert tp.fused_decision("auto", True, None, None) == (True, "")
    assert tp.fused_decision("auto", True, None, WHY) == (
        False, f"fused='auto': {WHY}")
    assert tp.fused_decision("auto", True, "timestepper 'EE'", WHY) == (
        False, "fused='auto': timestepper 'EE'")
    use, why = tp.fused_decision("auto", False, None, WHY)
    assert not use and "CUDA device only" in why
    with pytest.raises(NotImplementedError) as err:
        tp.fused_decision(True, True, None, WHY)
    assert str(err.value) == WHY
    assert tp.fused_decision(True, True, None, None) == (True, "")
    assert tp.fused_decision(True, False, None, WHY) == (True, "")
    assert tp.fused_decision(False, True, None, None)[0] is False


def _problems():
    """(name, port Problem with fused=True on the CPU): closed N = 64 on
    'streamk' past one block, and the open CNOT on superop (one block)."""
    closed = TProblem(port_setup(swap02_setup()), device="cpu")
    assert closed.fused_form == "streamk"
    sup = TProblem(port_setup(unguarded_setup(), fused_rho="superop"),
                   device="cpu")
    assert sup.fused_form == "superop"
    return (("closed", closed), ("superop", sup))


@pytest.mark.parametrize("budget", [1 << 12, 1 << 16])
def test_route_refusal_names_the_budget(monkeypatch, budget):
    """With DEVICE_BUDGET_BYTES patched below a sweep, route_refusal (sizes
    and budgets, no plan) gives the sentence of the route's own gate on
    the Problem's launch plan, naming the limit; 'auto' then takes the
    plain loop with that sentence and fused=True raises it. At the real
    budget both problems are admitted."""
    for name, pr in _problems():
        s = pr.setup
        args = (pr.fused_form, s.fused_mode, pr.ninit, pr.N, pr.model.K,
                s.linsolve_iters, s.ntime, pr.linsolver)
        assert tp.route_refusal(*args) is None, name
        monkeypatch.setattr(streamk, "DEVICE_BUDGET_BYTES", budget)
        why = tp.route_refusal(*args)
        plan = pr._plan
        assert why == streamk.route_refusal(
            pr.ninit, pr._Sr.shape[-1], plan.Ke, plan.iters, s.ntime,
            store=plan.store_iters), name
        assert "DEVICE_BUDGET_BYTES" in why, name
        assert TProblem(s, device="cpu").fused_refusal == why, name
        assert tp.fused_decision("auto", True, None, why) == (
            False, f"fused='auto': {why}")
        with pytest.raises(NotImplementedError, match="DEVICE_BUDGET_BYTES"):
            tp.fused_decision(s.fused, True, None, why)
        monkeypatch.undo()


def test_route_refusal_other_forms(monkeypatch):
    """The other routes' limits by name: 'chunk' past PLANE_BUDGET_BYTES
    (the reference has no byte gate there) and rho past N = 128 (the JAX
    Problem's lane-group line)."""
    monkeypatch.setattr(stream, "PLANE_BUDGET_BYTES", 1 << 16)
    why = tp.route_refusal("chunk", "chunk", 1, 256, 5, 8, 1000, "neumann")
    assert why is not None and "PLANE_BUDGET_BYTES" in why
    assert why == stream.route_refusal(1, 256, 8, 1000, 1, False, "chunk")
    why = tp.route_refusal("rho", "streamk", 3, 129, 7, 6, 1000, "jacobi")
    assert why == rho.launch_refusal(129, 7) and "problem.py:517" in why
    assert tp.route_refusal("rho", "streamk", 3, 125, 11, 6, 1000,
                            "jacobi") is None
