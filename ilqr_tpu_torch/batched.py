"""Fused batch-last solver engine — the production path for scenario batches.

Counterpart of ``ilqr_tpu/batched.py``.  Every array carries the scenario
batch as its trailing axis — trajectories ``[T+1, n, B]``, gains ``[T, m,
n, B]``, per-lane scalars ``[B]`` — so that elementwise work and the fused
Riccati kernel read consecutive lanes from consecutive addresses.  User
dynamics/cost callables are written per-scenario and batched with
``torch.func.vmap`` over that trailing axis, or called directly where the
problem promises that they take trailing batch axes
(``Problem.batch_trailing``).  Per-lane line search and convergence masks
are those of the JAX engine.

Where the JAX engine has ``lax.scan`` and ``lax.while_loop`` this one has
Python loops; a loop's condition on device data (``all lanes accepted``,
``any lane running``) costs one host synchronization per test.

The backward recursion runs in the fused CUDA kernel
(``backward_backend="pallas"``, the name kept from the JAX package) or as a
batch-last Python loop (``"scan"``).

Refused rather than ignored: ``backward_backend="associative"``,
``reg_in_value`` and ``ddp``.  The JAX fused engine ignores these three
silently and runs its default recursion (``ROADMAP.md`` C1); they exist in
the per-scenario engine (:mod:`ilqr_tpu_torch.solver`) of both packages.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
from torch.func import grad, jacfwd, vmap

from ilqr_tpu_torch.config import DEFAULT_CONFIG, ILQRConfig, Status
from ilqr_tpu_torch.derivatives import jacobians_trailing
from ilqr_tpu_torch.ops import smallmat as sm
from ilqr_tpu_torch.ops.cuda_riccati import (riccati_loop_bl,
                                             riccati_scan_cuda_bl)
from ilqr_tpu_torch.precision import highest_precision, resolve_device
from ilqr_tpu_torch.problem import Problem
from ilqr_tpu_torch.solver import SolverResult
from ilqr_tpu_torch.step import (StepEngine, finalize_status, ilqr_step,
                                 initial_state)


def _vmap_last(fn, n_in: int):
    """``vmap`` of a per-scenario function over the trailing axis of every
    input and output, results in the inputs' float type.

    Outputs are batched along axis 0 and then moved: a negative ``out_dims``
    fails in ``torch.func.vmap`` for an output that does not depend on the
    batched input (a constant Hessian block, say), axis 0 does not.

    The cast: inside ``vmap`` a per-scenario ``x[i]`` is a 0-d tensor, and
    ``torch.func`` promotes ``0-d float32 tensor <op> Python float`` to
    float64 there (the scalar loses its weak type under the batching rule).
    Such a function computes partly in float64 on float32 inputs; its
    result is rounded back so that the working type holds downstream.
    """

    inner = vmap(fn, in_dims=(-1,) * n_in, out_dims=0)

    def wrapped(*args):
        dtype = args[0].dtype

        def last(o):
            return o.movedim(0, -1).to(dtype)

        out = inner(*args)
        return tuple(map(last, out)) if isinstance(out, tuple) else last(out)

    return wrapped


def _batched_callables(problem: Problem):
    """``(dynamics, cost, final_cost)`` over a trailing lane axis:
    ``x [n, B], u [m, B] -> [n, B] / [B]``."""

    if problem.batch_trailing:
        return problem.dynamics, problem.cost, problem.final_cost
    bdyn = _vmap_last(problem.dynamics, 2)
    bcost = _vmap_last(problem.cost, 2)
    bfinal = _vmap_last(problem.final_cost, 1)
    return bdyn, bcost, bfinal


@highest_precision
def rollout_bl(problem: Problem, x0, us):
    """Open-loop rollout, batch-last: ``x0 [n, B]``, ``us [T, m, B]`` →
    ``xs [T+1, n, B]``."""

    bdyn, _, _ = _batched_callables(problem)
    xs = [x0]
    for t in range(us.shape[0]):
        xs.append(bdyn(xs[-1], us[t]))
    return torch.stack(xs, dim=0)


def total_cost_bl(problem: Problem, xs, us, x_ref=None):
    """Per-lane total cost ``[B]`` (same semantics as problem.total_cost)."""

    steps, final = step_costs_bl(problem, xs, us, x_ref)
    return torch.sum(steps, dim=0) + final


def step_costs_bl(problem: Problem, xs, us, x_ref=None):
    """Per-timestep running costs ``[T, B]`` and terminal cost ``[B]``
    (batch-last analogue of ``problem.step_costs``)."""

    _, bcost, bfinal = _batched_callables(problem)
    xs_run = xs[:-1]
    if x_ref is not None:
        xs_run = xs_run - x_ref[: xs_run.shape[0]]
    if problem.batch_trailing:
        # Time is one more trailing axis: x [n, T, B], u [m, T, B].
        steps = bcost(xs_run.movedim(0, 1), us.movedim(0, 1))
    else:
        steps = vmap(bcost)(xs_run, us)
    return steps, bfinal(xs[-1])


@highest_precision
def derivatives_bl(problem: Problem, xs, us, chunk: int = 0):
    """All local models, batch-last: returns
    ``As [T,n,n,B], Bs [T,n,m,B], qx [T,n,B], ru [T,m,B], Qxx [T,n,n,B],
    Pux [T,m,n,B], Ruu [T,m,m,B], qxN [n,B], QN [n,n,B]``, each contiguous.

    ``chunk > 0`` evaluates the horizon in serial chunks of that many
    timesteps instead of one whole-horizon ``vmap``: the jacfwd
    intermediates of a heavy dynamics only stay live for one chunk, which
    bounds peak memory at long T at the cost of a serial chunk loop.  ``T``
    must be divisible by ``chunk``; results agree with the unchunked sweep
    to rounding.
    """

    n = xs.shape[1]

    # A problem that takes trailing batch axes promises the same of its
    # ``dynamics_jacobians``: time is then one more trailing axis and the
    # hook runs once per sweep on ``x [n, T, B]``, outside any ``vmap``.
    jac_direct = (problem.dynamics_jacobians is not None
                  and problem.batch_trailing)
    if jac_direct:
        jac_b = None
    elif problem.dynamics_jacobians is not None:
        jac_b = _vmap_last(problem.dynamics_jacobians, 2)
    elif problem.batch_trailing:
        jac_b = jacobians_trailing(problem.dynamics)
    else:
        jac_b = _vmap_last(jacfwd(problem.dynamics, argnums=(0, 1)), 2)

    if problem.cost_quadratization is not None:
        def quad_one(x, u):
            _q, qx, ru, Qxx, Pux, Ruu = problem.cost_quadratization(x, u)
            return qx, ru, Qxx, Pux, Ruu
    else:
        def cost_z(z):
            return problem.cost(z[:n], z[n:])

        grad_z = grad(cost_z)
        hess_z = jacfwd(grad_z)

        def quad_one(x, u):
            z = torch.cat([x, u])
            gz = grad_z(z)
            Hz = hess_z(z)
            return gz[:n], gz[n:], Hz[:n, :n], Hz[n:, :n], Hz[n:, n:]

    quad_b = _vmap_last(quad_one, 2)

    def sweep(xs_c, us_c):
        """Local models of the steps ``xs_c [Tc, n, B]``, ``us_c [Tc, m,
        B]``."""

        if jac_direct:
            A, B = problem.dynamics_jacobians(xs_c.movedim(0, 1),
                                              us_c.movedim(0, 1))
            AB = (A.movedim(2, 0), B.movedim(2, 0))
        else:
            AB = vmap(jac_b)(xs_c, us_c)
        return AB + vmap(quad_b)(xs_c, us_c)

    T = us.shape[0]
    if chunk and chunk < T:
        assert T % chunk == 0, (T, chunk)
        parts = [sweep(xs[c:c + chunk], us[c:c + chunk])
                 for c in range(0, T, chunk)]
        out = tuple(torch.cat(p, dim=0) for p in zip(*parts))
    else:
        out = sweep(xs[:-1], us)

    if problem.final_cost_quadratization is not None:
        def final_one(x):
            _q, qxN, QN = problem.final_cost_quadratization(x)
            return qxN, QN

        qxN, QN = _vmap_last(final_one, 1)(xs[-1])
    else:
        fgrad = grad(problem.final_cost)
        qxN = _vmap_last(fgrad, 1)(xs[-1])
        QN = _vmap_last(jacfwd(fgrad), 1)(xs[-1])
    return tuple(o.contiguous() for o in out + (qxN, QN))


def _gains_sqrt(H, reg, g, G):
    return sm.cho_solve_gains_bl(sm.cholesky_bl(H, reg), g, G)


@highest_precision
def riccati_bl_scan(As, Bs, qx, ru, Qxx, Pux, Ruu, qxN, QN, reg,
                    symmetrize=True):
    """Batch-last backward recursion as a loop over time in plain PyTorch
    (the ``"scan"`` backend; ``sqrt`` then divide in the factorization, as
    ``ilqr_tpu.batched.riccati_bl_scan``)."""

    return riccati_loop_bl(As, Bs, qx, ru, Qxx, Pux, Ruu, qxN, QN, reg,
                           symmetrize, _gains_sqrt)


def riccati_bl(As, Bs, qx, ru, Qxx, Pux, Ruu, qxN, QN, reg, config):
    if config.backward_backend == "pallas":
        return riccati_scan_cuda_bl(
            As, Bs, qx, ru, Qxx, Pux, Ruu, qxN, QN, reg=reg,
            symmetrize=config.symmetrize)
    if config.backward_backend == "scan":
        return riccati_bl_scan(As, Bs, qx, ru, Qxx, Pux, Ruu, qxN, QN, reg,
                               symmetrize=config.symmetrize)
    raise NotImplementedError(
        f"backward_backend={config.backward_backend!r} is not ported; the "
        "batch-last engine has 'pallas' (the fused CUDA kernel) and 'scan'")


@highest_precision
def closed_loop_rollout_bl(problem: Problem, xs, us, duffs, Ks, alpha):
    """Per-lane closed-loop rollout: ``alpha [B]``."""

    bdyn, _, _ = _batched_callables(problem)
    T = us.shape[0]
    x_new = xs[0]
    xs_new, us_new = [], []
    for t in range(T):
        u_new = (us[t] + alpha[None, :] * duffs[t]
                 + sm.mv_bl(Ks[t], x_new - xs[t]))
        xs_new.append(x_new)
        us_new.append(u_new)
        x_new = bdyn(x_new, u_new)
    xs_new.append(x_new)
    return torch.stack(xs_new, dim=0), torch.stack(us_new, dim=0)


def _ls_threshold(config: ILQRConfig, alpha, dV1, dV2, dtype):
    """The decrease a rung at ``alpha`` must beat under
    ``config.ls_expected_decrease``: ``ls_c`` times the model's expected
    decrease, clamped at 0 (``alpha`` broadcasts against ``dV1``/``dV2``)."""

    exp_impr = -(alpha * dV1 + alpha * alpha * dV2)
    return (config.ls_c * torch.clamp(exp_impr, min=0.0)).to(dtype)


def _ls_accept(config: ILQRConfig, cost, prev_cost, thresh, delta=None,
               du_step_sq=None):
    """Whether a candidate of cost ``cost`` is accepted — the one rule of
    both ladders.  Under ``config.exact_ls_delta`` the decrease is the
    per-step ``delta``; a candidate identical to the iterate
    (``du_step_sq == 0``: the gain step underflowed the update) is the step
    the convergence test fires on, and is accepted whatever ``delta``'s
    re-evaluation noise says; an infinite ``prev_cost`` accepts any finite
    cost; ``isfinite``, not just ``~isnan``: an infinite first-iteration
    cost must backtrack."""

    if not config.exact_ls_delta:
        return (prev_cost - cost) > thresh
    ok = torch.logical_or(
        torch.logical_or(torch.isinf(prev_cost), -delta > thresh),
        du_step_sq == 0)
    return torch.logical_and(ok, torch.isfinite(cost))


@highest_precision
def forward_pass_bl(problem: Problem, xs, us, duffs, Ks, prev_cost,
                    x_ref=None, config: ILQRConfig = DEFAULT_CONFIG,
                    active=None, dV1=None, dV2=None, alpha_init=None):
    """Per-lane backtracking line search, batch-last.

    Each lane accepts the first alpha in 1, 1/2, … with any cost decrease
    (NaN rejected) and freezes; the loop runs until every lane accepted or
    the ladder is exhausted.  ``dV1``/``dV2`` ([B]) feed the optional
    expected-decrease acceptance (``config.ls_expected_decrease``).
    Returns ``(xs [T+1,n,B], us [T,m,B], cost [B], accepted [B], alpha [B],
    backtracks [B])``.
    """

    B = xs.shape[-1]
    dtype, device = xs.dtype, xs.device
    if active is None:
        active = torch.ones((B,), dtype=torch.bool, device=device)
    use_expected = config.ls_expected_decrease and dV1 is not None

    if config.exact_ls_delta:
        steps_old, final_old = step_costs_bl(problem, xs, us, x_ref)

    k = 0
    # alpha_init: per-lane warm-started first rung
    # (config.ls_alpha_warm_start; None = the reference's alpha0).
    alpha = (torch.full((B,), config.alpha0, dtype=dtype, device=device)
             if alpha_init is None else alpha_init.to(dtype))
    # Inactive lanes start "accepted" so they neither roll out usefully nor
    # keep the ladder spinning; the placeholder is masked off the returned
    # flag so callers see accepted=False for skipped lanes.
    accepted = ~active
    bts = torch.zeros((B,), dtype=torch.int32, device=device)
    xs_b, us_b = xs, us
    cost_b = torch.full((B,), float("inf"), dtype=dtype, device=device)

    # One host synchronization per test of the condition.
    while k < config.max_backtracks and not bool(torch.all(accepted)):
        xs_new, us_new = closed_loop_rollout_bl(problem, xs, us, duffs, Ks,
                                                alpha)
        thresh = (_ls_threshold(config, alpha, dV1, dV2, dtype)
                  if use_expected else 0.0)
        if config.exact_ls_delta:
            steps_new, final_new = step_costs_bl(problem, xs_new, us_new,
                                                 x_ref)
            cost = (torch.sum(steps_new, dim=0) + final_new).to(dtype)
            delta = (torch.sum(steps_new - steps_old, dim=0)
                     + (final_new - final_old)).to(dtype)
            du_step_sq = torch.sum((us_new - us) ** 2, dim=(0, 1))
            ok = _ls_accept(config, cost, prev_cost, thresh, delta,
                            du_step_sq)
        else:
            cost = total_cost_bl(problem, xs_new, us_new, x_ref).to(dtype)
            ok = _ls_accept(config, cost, prev_cost, thresh)
        accept_now = torch.logical_and(~accepted, ok)
        take = accept_now[None, None, :]
        xs_b = torch.where(take, xs_new, xs_b)
        us_b = torch.where(take, us_new, us_b)
        cost_b = torch.where(accept_now, cost, cost_b)
        bts = torch.where(accepted, bts, k)
        accepted = torch.logical_or(accepted, accept_now)
        alpha = torch.where(accepted, alpha, alpha * config.alpha_factor)
        k += 1

    # Ladder-exhausted lanes report backtracks == max_backtracks (the number
    # of rejected alphas).
    bts = torch.where(accepted, bts, k)
    return (xs_b, us_b, cost_b, torch.logical_and(accepted, active), alpha,
            bts)


@highest_precision
def forward_pass_bl_parallel(problem: Problem, xs, us, duffs, Ks, prev_cost,
                             x_ref=None,
                             config: ILQRConfig = DEFAULT_CONFIG,
                             active=None, dV1=None, dV2=None):
    """Parallel-alpha line search: evaluate ``R = config.
    parallel_alpha_block`` ladder rungs per block as extra lanes of ONE
    closed-loop rollout (lane ``r * B + b`` tries rung ``kb * R + r`` of
    lane ``b``).

    Decisions are those of :func:`forward_pass_bl` — the first accepting
    alpha in ladder order, the same ``exact_ls_delta`` and
    ``ls_expected_decrease`` rules — but the T-step rollout runs once per
    block instead of once per rung.  Blocks repeat until every lane
    accepted or ``max_backtracks`` rungs have been tried (one host
    synchronization a block).  Same returns as :func:`forward_pass_bl`.
    """

    R = config.parallel_alpha_block
    B = xs.shape[-1]
    dtype, device = xs.dtype, xs.device
    if active is None:
        active = torch.ones((B,), dtype=torch.bool, device=device)
    use_expected = config.ls_expected_decrease and dV1 is not None

    if config.exact_ls_delta:
        steps_old, final_old = step_costs_bl(problem, xs, us, x_ref)
    # x_ref goes with its lanes into the expanded batch (the JAX function
    # passes it untiled, which broadcasts only for B = 1).
    x_ref_r = None if x_ref is None else x_ref.repeat(1, 1, R)

    # The expanded batch, lane index r * B + b.
    xs_r = xs.repeat(1, 1, R)
    us_r = us.repeat(1, 1, R)
    duffs_r = duffs.repeat(1, 1, R)
    Ks_r = Ks.repeat(1, 1, 1, R)
    n_blocks = -(-config.max_backtracks // R)

    def per_rung(reduce, x):
        """``reduce`` of each rung's lanes ``x[..., r*B:(r+1)*B]``, stacked
        ``[R, ...]``: every sum over time runs on a batch of B lanes, the
        shape the sequential ladder sums, because a reduction's order of
        operations may depend on the width of the batch."""

        return torch.stack([reduce(x[..., r * B:(r + 1) * B].contiguous())
                            for r in range(R)])

    def try_block(kb, alphas):
        """Every candidate of block ``kb``: rungs kb*R ... kb*R+R-1, at
        ``alphas [R]``."""

        rungs = kb * R + torch.arange(R, device=device)
        alpha_vec = alphas.repeat_interleave(B)                   # [R*B]
        xs_new, us_new = closed_loop_rollout_bl(problem, xs_r, us_r,
                                                duffs_r, Ks_r, alpha_vec)
        thresh = (_ls_threshold(config, alphas[:, None], dV1[None, :],
                                dV2[None, :], dtype)
                  if use_expected else 0.0)
        steps_new, final_new = step_costs_bl(problem, xs_new, us_new,
                                             x_ref_r)
        cost = (per_rung(lambda s: torch.sum(s, dim=0), steps_new)
                + final_new.reshape(R, B)).to(dtype)
        if config.exact_ls_delta:
            delta = (per_rung(lambda s: torch.sum(s - steps_old, dim=0),
                              steps_new)
                     + (final_new.reshape(R, B) - final_old[None, :])
                     ).to(dtype)
            du_step_sq = per_rung(
                lambda u: torch.sum((u - us) ** 2, dim=(0, 1)), us_new)
            ok = _ls_accept(config, cost, prev_cost[None, :], thresh, delta,
                            du_step_sq)
        else:
            ok = _ls_accept(config, cost, prev_cost[None, :], thresh)
        # Rungs past the sequential ladder's budget must not accept.
        ok = torch.logical_and(ok, (rungs < config.max_backtracks)[:, None])
        return xs_new, us_new, cost, ok

    kb = 0
    accepted = ~active
    bts = torch.zeros((B,), dtype=torch.int32, device=device)
    alpha_b = torch.full((B,), config.alpha0, dtype=dtype, device=device)
    xs_b, us_b = xs, us
    cost_b = torch.full((B,), float("inf"), dtype=dtype, device=device)
    # The ladder's alphas as the sequential ladder makes them: each rung's
    # is the one before times alpha_factor, in the working dtype.
    ladder = [torch.tensor(config.alpha0, dtype=dtype, device=device)]
    # One host synchronization per test of the condition.
    while kb < n_blocks and not bool(torch.all(accepted)):
        while len(ladder) <= (kb + 1) * R:
            ladder.append(ladder[-1] * config.alpha_factor)
        alphas = torch.stack(ladder[kb * R:(kb + 1) * R])
        xs_new, us_new, cost, ok = try_block(kb, alphas)
        first = torch.argmax(ok.to(torch.int32), dim=0)           # [B]
        any_ok = torch.any(ok, dim=0)
        accept_now = torch.logical_and(~accepted, any_ok)

        def pick(x):
            xr = x.reshape(x.shape[:-1] + (R, B))
            idx = first.reshape((1,) * (xr.ndim - 2) + (1, B)).expand(
                xr.shape[:-2] + (1, B))
            return torch.gather(xr, -2, idx)[..., 0, :]

        take = accept_now[None, None, :]
        xs_b = torch.where(take, pick(xs_new), xs_b)
        us_b = torch.where(take, pick(us_new), us_b)
        cost_b = torch.where(accept_now,
                             torch.gather(cost, 0, first[None, :])[0], cost_b)
        alpha_b = torch.where(accept_now, alphas[first], alpha_b)
        bts = torch.where(accept_now, (kb * R + first).to(torch.int32), bts)
        # Lanes still unaccepted have rejected every rung tried so far; they
        # report the alpha after the last rejected rung, as the sequential
        # ladder's carry does on exhaustion.
        tried = min((kb + 1) * R, config.max_backtracks)
        settled = torch.logical_or(accepted, accept_now)
        bts = torch.where(settled, bts, tried)
        alpha_b = torch.where(settled, alpha_b, ladder[tried])
        accepted = settled
        kb += 1
    return (xs_b, us_b, cost_b, torch.logical_and(accepted, active),
            alpha_b, bts)


def make_batch_last_engine(problem: Problem, x_ref_bl,
                           config: ILQRConfig) -> StepEngine:
    """The batch-last StepEngine: every lane-shaped value is ``[B]`` and
    trajectories carry a trailing lane axis.  ``parallel_alpha_block > 0``
    runs the ladder as :func:`forward_pass_bl_parallel`.

    Raises ``NotImplementedError`` on ``backward_backend="associative"``,
    ``reg_in_value`` and ``ddp``: the JAX fused engine ignores them silently
    and runs its default recursion (``ROADMAP.md`` C1); the port does not
    copy that, and does not add them either — they belong to the
    per-scenario engine in both packages.
    """

    refused = {
        "backward_backend='associative'":
            config.backward_backend == "associative",
        "reg_in_value=True": config.reg_in_value,
        "ddp=True": config.ddp,
    }
    for flag, is_set in refused.items():
        if is_set:
            raise NotImplementedError(
                f"{flag} is not implemented by the batch-last engine of "
                "ilqr_tpu_torch; the per-scenario engine "
                "(make_batch_solver(engine='vmap'), solver.solve) has it")

    def backward(xs, us, reg):
        models = derivatives_bl(problem, xs, us,
                                chunk=config.derivative_chunk)
        return riccati_bl(*models, reg=reg, config=config)

    def forward(xs, us, duffs, Ks, prev_cost, active, dV1, dV2,
                alpha_init=None):
        if config.parallel_alpha_block > 0:
            # alpha_init is rejected at config construction for this path.
            return forward_pass_bl_parallel(
                problem, xs, us, duffs, Ks, prev_cost, x_ref_bl, config,
                active=active, dV1=dV1, dV2=dV2)
        return forward_pass_bl(problem, xs, us, duffs, Ks, prev_cost,
                               x_ref_bl, config, active=active, dV1=dV1,
                               dV2=dV2, alpha_init=alpha_init)

    return StepEngine(
        backward=backward,
        forward=forward,
        du_sq=lambda a, b: torch.sum((a - b) ** 2, dim=(0, 1)),
        select=torch.where,
        select_traj=lambda m, new, old: torch.where(m[None, None, :], new,
                                                    old),
    )


def _result_from_state(problem: Problem, state, x_ref_bl) -> SolverResult:
    """The batch-first ``SolverResult`` of a final batch-last state."""

    status = finalize_status(state.status)
    cost = torch.where(
        torch.isinf(state.prev_cost),
        total_cost_bl(problem, state.xs, state.us,
                      x_ref_bl).to(state.xs.dtype),
        state.prev_cost)
    return SolverResult(
        xs=state.xs.movedim(-1, 0),
        us=state.us.movedim(-1, 0),
        cost=cost,
        iterations=state.iteration,
        status=status,
        reg=state.reg,
        alpha=state.alpha,
        du_sq=state.du_sq,
    )


def make_chunked_batch_solver(problem: Problem,
                              config: ILQRConfig = DEFAULT_CONFIG,
                              iter_chunk: int = 10,
                              x_ref=None,
                              on_chunk=None,
                              snapshot_every: int = 0,
                              max_retries: int = 2,
                              snapshot_path: Optional[str] = None,
                              compact_sizes=(),
                              _fault_hook=None,
                              device=None):
    """A chunked variant of :func:`batched_solve_fused`.

    Returns ``solve_fn(xs0, us0) -> SolverResult`` (batch-FIRST interface,
    same results as :func:`batched_solve_fused`) that runs the solver loop
    in chunks of at most ``iter_chunk`` passes.  After each chunk
    ``on_chunk(n_passes, n_running)`` is called (progress, logging, early
    abort: return True to stop), and the batch may be compacted.

    ``x_ref`` (batch-first ``[B, T, n]`` or None) is baked into the returned
    solver, mirroring ``make_batch_solver``'s static problem.

    ``compact_sizes`` (descending lane counts, e.g. ``(128, 32)``) turns on
    STRAGGLER COMPACTION: once the number of RUNNING lanes fits a listed
    size, the finished lanes are written back to a copy of the full batch
    and the solve continues with only the stragglers, gathered into a
    smaller batch (padded up to the listed size with finished lanes, which
    stay frozen).  A solve whose last tenth of the lanes runs several times
    longer than the rest then pays those tail passes for the lanes that
    need them.  The choice of target size, the padding and the write-back
    are those of the JAX package; there the gather goes through host
    memory because its compiled programs have fixed shapes, here it is an
    ``index_select`` and an indexed assignment along the lane axis on the
    device.  The step body is per-lane, so compaction changes no lane's
    arithmetic.

    ``snapshot_every > 0`` keeps a HOST SNAPSHOT — the solver state of the
    full batch (compacted lanes merged back) as numpy arrays, and the pass
    count — every that-many chunks, and retries a chunk that fails with
    ``torch.AcceleratorError`` (the error a CUDA fault raises where the
    host synchronizes) from the last snapshot, up to ``max_retries``
    consecutive times (the count resets after a chunk that succeeds).
    Before a retry the device is probed with a small allocation and a
    synchronize: a sticky CUDA error, which no retry in this process can
    clear, raises there at once.  A retry reruns the same code, kernels
    included.  Nothing else is retried: a ``RuntimeError`` of a kernel
    launch that failed, a build error or a Python error propagates.

    ``snapshot_path`` extends this across processes: every host snapshot
    (every chunk if ``snapshot_every`` is 0) is also saved to that file with
    :func:`ilqr_tpu_torch.utils.checkpoint.save_solver_state`, in the JAX
    package's format — ``{"state": StepState, "n_passes": int64}``,
    batch-last — and a ``solve_fn`` that finds the file at entry resumes
    from it.  A snapshot of either package resumes in the other.  The file
    is removed when the solve returns, also after ``on_chunk`` stopped it.

    ``_fault_hook(chunk_idx)`` is called before each chunk (a test seam for
    injected faults).  Runs on ``device`` (default: the card).
    """

    from ilqr_tpu_torch.utils.checkpoint import (load_solver_state,
                                                 save_solver_state)

    device = resolve_device(device)
    x_ref_bl = (None if x_ref is None
                else x_ref.to(device).movedim(0, -1).contiguous())
    running_code = int(Status.RUNNING)
    sizes = tuple(sorted(set(int(s) for s in compact_sizes), reverse=True))
    every = snapshot_every if snapshot_every > 0 else (
        1 if snapshot_path is not None else 0)

    def gather(state, idx):
        return type(state)(*(a.index_select(-1, idx) for a in state))

    def scatter(full, cur, idx):
        """``full[..., idx] = cur`` on a copy.  ``idx`` holds no lane twice:
        it is a selection of distinct lanes of a selection of distinct
        lanes."""

        out = []
        for f, c in zip(full, cur):
            f = f.clone()
            f[..., idx] = c
            out.append(f)
        return type(full)(*out)

    def to_host(state):
        return type(state)(*(a.detach().cpu().numpy() for a in state))

    def to_device(host_state):
        return type(host_state)(*(torch.as_tensor(a).to(device)
                                  for a in host_state))

    @highest_precision
    def solve_fn(xs0, us0):
        xs_bl = xs0.to(device).movedim(0, -1).contiguous()
        us_bl = us0.to(device).movedim(0, -1).contiguous()
        B = xs_bl.shape[-1]
        state = initial_state(xs_bl, us_bl, config, lane_shape=(B,))
        n_passes = 0
        # Straggler-compaction bookkeeping: ``full`` holds the finished
        # lanes of the ORIGINAL batch, ``cur_idx`` maps each current lane to
        # its original index, ``cur_ref`` is x_ref gathered likewise.
        # None ⇔ the state is still the full batch.
        full = None
        cur_idx = None
        cur_ref = x_ref_bl
        engine = make_batch_last_engine(problem, cur_ref, config)

        def merged():
            return state if full is None else scatter(full, state, cur_idx)

        # The host snapshot: (full-batch state as numpy, passes).
        snapshot = (to_host(state), 0) if every else None
        if snapshot_path is not None and os.path.exists(snapshot_path):
            # Cross-process resume: an earlier process saved its progress.
            saved = load_solver_state(snapshot_path, {
                "state": snapshot[0], "n_passes": np.int64(0)})
            snapshot = (saved["state"], int(saved["n_passes"]))
            state, n_passes = to_device(snapshot[0]), snapshot[1]

        chunk_idx = 0
        retries = 0
        while True:
            try:
                if _fault_hook is not None:
                    _fault_hook(chunk_idx)
                k = 0
                # One host synchronization per test of the condition.
                while (k < iter_chunk and n_passes < config.max_iter
                       and bool(torch.any(state.status == running_code))):
                    state = ilqr_step(engine, config, state)[0]
                    n_passes += 1
                    k += 1
                # This read is the synchronize that surfaces a deferred
                # device fault of the chunk, so it stays inside the try.
                n_running = int(torch.sum(state.status == running_code))
            except torch.AcceleratorError:
                if snapshot is None or retries >= max_retries:
                    raise
                retries += 1
                # Probe the device: a sticky error raises here at once
                # instead of burning retries.  (There is no compiled
                # program to drop before retrying, unlike the JAX
                # package's run_chunk.clear_cache(); eager torch reruns the
                # same code.)
                torch.zeros((), device=device)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                # A snapshot holds the full batch: restoring it undoes any
                # compaction (the next chunks compact again).
                state, n_passes = to_device(snapshot[0]), snapshot[1]
                full, cur_idx, cur_ref = None, None, x_ref_bl
                engine = make_batch_last_engine(problem, cur_ref, config)
                continue
            retries = 0  # max_retries bounds CONSECUTIVE faults
            chunk_idx += 1
            if every and chunk_idx % every == 0:
                snapshot = (to_host(merged()), n_passes)
                if snapshot_path is not None:
                    save_solver_state(snapshot_path, {
                        "state": snapshot[0],
                        "n_passes": np.int64(n_passes)})
            if on_chunk is not None and on_chunk(n_passes, n_running):
                break
            if n_running == 0 or n_passes >= config.max_iter:
                break
            if sizes:
                cur_B = state.status.shape[-1]
                # Smallest listed size that still fits the stragglers and
                # shrinks the batch.
                fits = [s for s in sizes if n_running <= s < cur_B]
                if fits:
                    target = fits[-1]
                    if full is None:
                        full = state
                        cur_idx = torch.arange(cur_B, device=device)
                    else:
                        full = scatter(full, state, cur_idx)
                    is_running = state.status == running_code
                    running = torch.nonzero(is_running).flatten()
                    done = torch.nonzero(~is_running).flatten()
                    local_sel = torch.cat(
                        [running, done[:target - running.numel()]])
                    state = gather(state, local_sel)
                    cur_idx = cur_idx[local_sel]
                    if x_ref_bl is not None:
                        cur_ref = x_ref_bl.index_select(-1, cur_idx)
                        engine = make_batch_last_engine(problem, cur_ref,
                                                        config)
        if snapshot_path is not None and os.path.exists(snapshot_path):
            os.remove(snapshot_path)
        return _result_from_state(problem, merged(), x_ref_bl)

    return solve_fn


@highest_precision
def batched_solve_fused(problem: Problem, xs0, us0,
                        x_ref: Optional[torch.Tensor] = None,
                        config: ILQRConfig = DEFAULT_CONFIG,
                        device=None) -> SolverResult:
    """Solve a batch of scenarios with the fused batch-last engine.

    Batch-FIRST interface (matching ``parallel.batch_solve``):
    ``xs0 [B, T+1, n]``, ``us0 [B, T, m]`` → SolverResult with batch axis
    first on every field.  Internally everything runs batch-last; the two
    transposes at entry/exit are the only layout moves.  The iteration body
    is the shared :func:`ilqr_tpu_torch.step.ilqr_step`.

    Runs on ``device`` (default: the card; see
    :func:`ilqr_tpu_torch.precision.resolve_device`).
    """

    device = resolve_device(device)
    # To batch-last.
    xs_bl = xs0.to(device).movedim(0, -1).contiguous()   # [T+1, n, B]
    us_bl = us0.to(device).movedim(0, -1).contiguous()   # [T, m, B]
    x_ref_bl = (None if x_ref is None
                else x_ref.to(device).movedim(0, -1).contiguous())
    B = xs_bl.shape[-1]

    engine = make_batch_last_engine(problem, x_ref_bl, config)

    # A global pass counter runs alongside the per-lane iteration counts (a
    # finished lane stops counting but the loop keeps going for the
    # stragglers).  One host synchronization per test of the condition.
    state = initial_state(xs_bl, us_bl, config, lane_shape=(B,))
    n_passes = 0
    while (n_passes < config.max_iter
           and bool(torch.any(state.status == int(Status.RUNNING)))):
        state = ilqr_step(engine, config, state)[0]
        n_passes += 1

    return _result_from_state(problem, state, x_ref_bl)
