"""Batched projected L-BFGS on the device: optimize MANY control candidates
in parallel with no host round trip per iteration.

The optimizer counterpart of the ensemble axis: multi-start optimization
where E candidates each run a projected L-BFGS with a fixed iteration
count. Every step of an iteration is a tensor operation over the candidate
axis on the inputs' device; nothing is fetched until the caller reads the
result. The line search is itself parallel: all backtracking step lengths
of all candidates are evaluated as batched objective calls and the first
Armijo-satisfying one is selected.

Counterpart of quandary_tpu/optim/batched_lbfgs.py (one jit there; here the
loop over iterations is a Python loop that only enqueues device work).
"""

from __future__ import annotations

from typing import Callable

import torch


def _rows(A, idx):
    """A[e, idx[e]] for A (E, m, ...) and idx (E,), without a host sync."""
    return A[torch.arange(A.shape[0], device=A.device), idx]


def _two_loop(g, S, Y, rho, count):
    """L-BFGS two-loop per candidate over circular (E, m, n) histories.
    Slot (count-1-j) % m is the j-th newest pair; slots j >= count masked."""
    m = S.shape[1]
    tiny = torch.finfo(g.dtype).tiny
    q = g
    alphas = []
    for j in range(m):
        idx = (count - 1 - j) % m
        valid = j < count
        Sj, Yj, rj = _rows(S, idx), _rows(Y, idx), _rows(rho, idx)
        a = torch.where(valid, rj * torch.sum(Sj * q, -1), 0.0)
        q = q - a[:, None] * Yj
        alphas.append((Sj, Yj, rj, valid, a))
    newest = (count - 1) % m
    Sn, Yn = _rows(S, newest), _rows(Y, newest)
    sy = torch.sum(Sn * Yn, -1)
    yy = torch.sum(Yn * Yn, -1)
    gamma = torch.where(count > 0, sy / torch.clamp(yy, min=tiny), 1.0)
    q = q * gamma[:, None]
    for Sj, Yj, rj, valid, a in reversed(alphas):
        b = torch.where(valid, rj * torch.sum(Yj * q, -1), 0.0)
        q = q + torch.where(valid, a - b, 0.0)[:, None] * Sj
    return q


def _projected_grad(x, g, lb, ub):
    at_lb = (x <= lb + 1e-12) & (g > 0)
    at_ub = (x >= ub - 1e-12) & (g < 0)
    return torch.where(at_lb | at_ub, 0.0, g)


def _direction(x, g, S, Y, rho, count, lb, ub):
    """Search directions (E, n): two-loop with the descent safeguard
    (fall back to -pg) and the first-step cap (lbfgsb._first_step_cap
    semantics): with no curvature memory d = -g is unscaled; if it dwarfs
    the box, every backtracked trial projects onto the same corner, Armijo
    never holds, and the candidate never moves. Cap the direction so the
    unit trial step crosses at most a quarter of the box."""
    tiny = torch.finfo(g.dtype).tiny
    pg = _projected_grad(x, g, lb, ub)
    d = -_two_loop(g, S, Y, rho, count)
    desc = torch.sum(d * pg, -1)
    d = torch.where((desc < 0)[:, None], d, -pg)
    width = torch.where(ub - lb < 1e9, ub - lb, torch.inf)
    dmax = torch.amax(d.abs() / torch.clamp(width, min=tiny), dim=1)
    cap = torch.clamp(0.25 / torch.clamp(dmax, min=tiny), max=1.0)
    return torch.where((count == 0)[:, None], cap[:, None] * d, d)


def _remember(S, Y, rho, count, s, y, good):
    """Store the pairs (s, y) of the candidates marked `good` in their
    next circular slot."""
    m = S.shape[1]
    sy = torch.sum(s * y, -1)
    slot = count % m
    put = good[:, None] & (torch.arange(m, device=S.device) == slot[:, None])
    S = torch.where(put[:, :, None], s[:, None, :], S)
    Y = torch.where(put[:, :, None], y[:, None, :], Y)
    rho = torch.where(put, (1.0 / torch.where(good, sy, 1.0))[:, None], rho)
    return S, Y, rho, count + good.to(count.dtype)


def _derived_hooks(objective):
    """Batch hooks of a plain torch objective(x) -> scalar."""
    from torch.func import grad_and_value, vmap

    def vg_b(xs):
        g, f = vmap(grad_and_value(objective))(xs)
        return f, g

    return vmap(objective), lambda xs: vg_b(xs)[1], vg_b


def batched_lbfgsb(
    objective: Callable,
    grad: Callable,
    x0s,                       # (E, n)
    lb, ub,                    # (n,)
    *,
    iters: int = 50,
    history: int = 8,
    ls_lengths: int = 10,
    c1: float = 1e-4,
    objective_batch: Callable = None,
    grad_batch: Callable = None,
    vg_batch: Callable = None,
    speculative: bool = True,
    ls_warmup: int = 3,
    return_stats: bool = False,
):
    """Run `iters` projected L-BFGS iterations for every candidate.

    `objective_batch(xs (E, n)) -> (E,)`, `grad_batch(xs) -> (E, n)` and
    `vg_batch(xs) -> ((E,), (E, n))` evaluate the population;
    Problem.packed_batch_fns supplies all three as ensemble launches of
    the streamK kernels. Without any hook they are derived from
    `objective(x) -> scalar`, which must then be a plain torch function
    that torch.func can differentiate and vmap; `grad` is accepted for the
    JAX signature and not needed.

    speculative (default): after `ls_warmup` classic backtracking
    iterations, the line search switches to a SPECULATIVE per-candidate
    step scale: one batched value_and_grad at each candidate's remembered
    scale is the ENTIRE iteration cost. Armijo acceptors move and grow
    their scale back toward the unit step, rejectors stay and halve it (a
    rejection costs one iteration, not a ladder of forward launches for
    the whole population). The warm-up ladder initializes each scale at
    the first accepted trial length. This trades the classic guarantee
    (every iteration moves if ANY trial length passes) for a much cheaper
    steady-state iteration.

    Returns (x_best (E, n), f_best (E,), f_trace (iters+1, E)) as tensors
    on the device of x0s; with return_stats=True appends a dict:
    'ladder_iters' (iterations that ran the classic ladder), 'rejected'
    (total rejected candidate-iterations, counting BOTH ladder iterations
    whose whole trial row failed and speculative-phase rejections; a
    0-dim tensor).

    Cost note: the one-value_and_grad-per-iteration steady state needs
    `vg_batch`. With only objective_batch/grad_batch an iteration costs a
    forward plus a separate gradient.
    """
    x0s = torch.as_tensor(x0s)
    kw = dict(dtype=x0s.dtype, device=x0s.device)
    lb, ub = torch.as_tensor(lb, **kw), torch.as_tensor(ub, **kw)
    m = history
    E, n = x0s.shape

    if objective_batch is None and grad_batch is None and vg_batch is None:
        obj_b, grad_b, vg_b = _derived_hooks(objective)
    elif objective_batch is None or (grad_batch is None and vg_batch is None):
        raise ValueError("batch hooks need objective_batch and one of "
                         "grad_batch, vg_batch")
    else:
        obj_b = objective_batch
        grad_b = grad_batch if grad_batch is not None \
            else (lambda xs: vg_batch(xs)[1])
        vg_b = vg_batch if vg_batch is not None \
            else (lambda xs: (obj_b(xs), grad_b(xs)))
    ts = 0.5 ** torch.arange(ls_lengths, **kw)               # (L,)

    def project(x):
        return torch.minimum(torch.maximum(x, lb), ub)

    x = project(x0s)
    f, g = vg_b(x)
    S = torch.zeros((E, m, n), **kw)
    Y = torch.zeros((E, m, n), **kw)
    rho = torch.zeros((E, m), **kw)
    count = torch.zeros((E,), dtype=torch.int64, device=x.device)
    xbest, fbest = x, f
    tscale = torch.ones((E,), **kw)
    nrej = torch.zeros((), dtype=torch.int64, device=x.device)

    def ladder(x, f, g, d, tscale):
        # classic parallel backtracking: every candidate's step lengths,
        # one batched objective per step length (L forward launches of E
        # candidates: peak memory scales with E, not E*L)
        xc = project(x[:, None, :] + ts[None, :, None] * d[:, None, :])
        fc = torch.stack([obj_b(xc[:, l]) for l in range(ls_lengths)], dim=1)
        dx = xc - x[:, None, :]
        armijo = fc <= f[:, None] + c1 * torch.einsum("en,eln->el", g, dx)
        any_ok = armijo.any(dim=1)
        pick = torch.where(any_ok, armijo.to(torch.int8).argmax(dim=1), 0)
        x_new = torch.where(any_ok[:, None], _rows(xc, pick), x)
        f_new = torch.where(any_ok, _rows(fc, pick), f)
        g_new = grad_b(x_new)
        # remember the accepted trial length as the candidate's scale for
        # the speculative phase; total rejection halves it
        t_new = torch.where(any_ok, ts[pick], tscale * 0.5)
        return x_new, f_new, g_new, t_new, torch.sum(~any_ok)

    def adaptive(x, f, g, d, tscale):
        # speculative per-candidate scale: ONE batched value_and_grad at
        # each candidate's remembered step scale is the whole iteration
        x1 = project(x + tscale[:, None] * d)
        f1, g1 = vg_b(x1)
        ok = f1 <= f + c1 * torch.sum(g * (x1 - x), -1)
        x_new = torch.where(ok[:, None], x1, x)
        f_new = torch.where(ok, f1, f)
        g_new = torch.where(ok[:, None], g1, g)
        t_new = torch.where(ok, torch.clamp(tscale * 2.0, max=1.0),
                            tscale * 0.5)
        return x_new, f_new, g_new, t_new, torch.sum(~ok)

    nwarm = min(ls_warmup, iters) if speculative else iters
    ftrace = [f]
    for it in range(iters):
        d = _direction(x, g, S, Y, rho, count, lb, ub)
        search = ladder if it < nwarm else adaptive
        x_new, f_new, g_new, tscale, rej = search(x, f, g, d, tscale)
        nrej = nrej + rej
        s = x_new - x
        y = g_new - g
        # non-acceptors keep x (s = 0, so sy = 0); the curvature guard
        # alone filters them
        good = torch.sum(s * y, -1) > 1e-12
        S, Y, rho, count = _remember(S, Y, rho, count, s, y, good)
        better = f_new < fbest
        xbest = torch.where(better[:, None], x_new, xbest)
        fbest = torch.where(better, f_new, fbest)
        x, f, g = x_new, f_new, g_new
        ftrace.append(f)
    ftrace = torch.stack(ftrace)
    if return_stats:
        return xbest, fbest, ftrace, {"ladder_iters": nwarm, "rejected": nrej}
    return xbest, fbest, ftrace
