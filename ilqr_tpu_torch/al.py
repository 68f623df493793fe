"""Augmented-Lagrangian iLQR: general state/control inequality and
equality constraints.

Counterpart of ``ilqr_tpu/al.py``.  The reference has no constraint
handling at all — it parses URDF effort/velocity limits
(test/urdf/2Dof_arm.urdf) and never enforces them (SURVEY.md §2.2).
:func:`ilqr_tpu_torch.constraints.box_constrained` covers control boxes by
smooth squashing; this module is the general mechanism, an
augmented-Lagrangian outer loop (the AL-iLQR / ALTRO scheme) around the
unmodified inner solver.

Formulation.  Per-step constraints ``c(x, u) -> [p]`` with ``c <= 0``
feasible (inequality rows) or ``c == 0`` (equality rows), and an optional
terminal ``c_T(x) -> [pT]``.  The inner solve minimizes

    L_AL(x, u) = L(x, u) + lam' c + 1/2 mu * sum_i a_i(c, lam) c_i^2

where ``a_i = 1`` for equality rows and for inequality rows with
``c_i >= 0 or lam_i > 0`` (the active set), else 0.  After each inner solve
the multipliers take a projected dual-ascent step ``lam <- max(0, lam + mu
c)`` (unprojected for equalities) and the penalty escalates ``mu <- min(beta
mu, mu_max)`` while the largest violation has not met its target decrease.

Mechanics.  As in the JAX package, the step index is carried as a trailing
state coordinate, so that the per-step multipliers are looked up inside the
per-scenario cost with zero derivative (the coordinate is uncontrollable:
its rows of the local models are exact zeros, and both packages run the
same arithmetic on the same ``n + 1`` states).  Where the JAX package vmaps
``al_solve`` over scenarios, a scenario's multipliers are batched with its
cost; here scenarios are leading batch axes and the callables are
per-scenario, so the coordinate starts at ``lane * T`` instead of 0 and the
cost reads row ``lane * T + k`` of the lanes' stacked multipliers (the
coordinate's value enters no other arithmetic; it stays an exact integer
while ``lanes * (T + 1)`` is below 2^24 in float32).  A larger batch is
solved in sub-batches of at most :func:`_exact_lanes` scenarios, each
numbering its steps from 0, and concatenated: the scenarios are independent,
so that is the same solve.  Only a single scenario whose ``T + 1`` is past
the bound raises ``ValueError``.  The outer loop runs
at most ``max_outer`` times on the leading-axis ``solve``; a lane that is
done is frozen, and the loop ends once every lane is.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, NamedTuple, Optional

import torch

from ilqr_tpu_torch.config import DEFAULT_CONFIG, ILQRConfig, Status
from ilqr_tpu_torch.precision import highest_precision, resolve_device
from ilqr_tpu_torch.problem import (Problem, over_leading, problem_dynamics,
                                    rollout, total_cost)
from ilqr_tpu_torch.solver import solve
from ilqr_tpu_torch.step import lane_where


@dataclasses.dataclass(frozen=True)
class ALConfig:
    """Outer-loop configuration (the JAX package's, field for field)."""

    max_outer: int = 10
    mu0: float = 1.0
    mu_scale: float = 10.0
    mu_max: float = 1e8
    constraint_tol: float = 1e-4
    # Escalate mu only when max violation did not shrink by this factor.
    viol_decrease: float = 0.25
    lam_max: float = 1e8


class ALResult(NamedTuple):
    xs: torch.Tensor              # [*L, T+1, n] (un-augmented)
    us: torch.Tensor              # [*L, T, m]
    cost: torch.Tensor            # original (unaugmented) trajectory cost
    max_violation: torch.Tensor   # max over steps/rows of constraint violation
    outer_iterations: torch.Tensor
    inner_iterations: torch.Tensor  # total inner iLQR iterations
    status: torch.Tensor          # Status.CONVERGED iff feasible + inner done
    lam: torch.Tensor             # [*L, T, p] final running multipliers
    lam_T: torch.Tensor           # [*L, pT] final terminal multipliers
    mu: torch.Tensor              # [*L] final penalty weight


def _exact_lanes(dtype: torch.dtype, T: int) -> int:
    """The most scenarios whose step coordinate ``lane * T + k`` stays an
    exact integer of ``dtype``: ``lanes * (T + 1)`` below ``2 / eps``
    (2^24 in float32).  0 where not even one scenario's does."""

    exact_below = round(2 / torch.finfo(dtype).eps)
    return (exact_below - 1) // (T + 1)


def _violation(c, is_eq):
    """Per-row violation magnitude: |c| for equalities, max(c, 0) else."""

    return torch.where(is_eq, torch.abs(c), torch.clamp(c, min=0.0))


def _al_penalty(c, lam, mu, is_eq):
    """lam'c + (mu/2) * sum active c_i^2 (active set per docstring), summed
    over the rows, the first axis of ``c [p, ...]``.  The constants are 0-d
    tensors of ``c``'s type: a Python float would widen float32 under
    ``torch.func`` (``ROADMAP.md`` C4, C8)."""

    zero = torch.zeros((), dtype=c.dtype, device=c.device)
    half = torch.full((), 0.5, dtype=c.dtype, device=c.device)
    is_eq = is_eq.reshape(is_eq.shape + (1,) * (c.ndim - 1))
    active = is_eq | (c >= zero) | (lam > zero)
    quad = torch.where(active, c * c, zero)
    return (torch.sum(lam * c, dim=0)
            + half * mu * torch.sum(quad, dim=0))


def _augment_problem(problem: Problem, constraint, constraint_T,
                     lam_rows, lam_T_rows, mu_rows, is_eq, is_eq_T,
                     T: int) -> Problem:
    """The inner (unconstrained) problem over the index-augmented state
    ``[x; lane * T + k]``: ``lam_rows [lanes * T, p]``, ``lam_T_rows
    [lanes, pT]``, ``mu_rows [lanes]``.  Its callables take trailing batch
    axes where ``problem``'s do (then so must the constraints)."""

    lanes = mu_rows.shape[0]

    def take(rows, i):
        """Rows ``i`` of ``rows [R, *tail]`` as ``[*tail, *i.shape]`` (the
        index's axes trailing, as the state's are); ``i`` may be a 0-d index
        batched under ``vmap``."""

        out = torch.index_select(rows, 0, i.reshape(-1))
        out = out.reshape(i.shape + rows.shape[1:])
        return out.movedim(tuple(range(i.ndim)),
                           tuple(range(out.ndim - i.ndim, out.ndim)))

    def dynamics(xk, u):
        x, k = xk[:-1], xk[-1]
        one = torch.ones((), dtype=xk.dtype, device=xk.device)
        return torch.cat([problem.dynamics(x, u), (k + one)[None]])

    def cost(xk, u):
        x, k = xk[:-1], xk[-1]
        row = torch.clamp(k.to(torch.int64), 0, lanes * T - 1)
        c = constraint(x, u)
        return problem.cost(x, u) + _al_penalty(
            c, take(lam_rows, row), take(mu_rows, row // T), is_eq)

    def final_cost(xk):
        x, k = xk[:-1], xk[-1]
        base = problem.final_cost(x)
        if constraint_T is None:
            return base
        lane = torch.clamp(k.to(torch.int64) // T - 1, 0, lanes - 1)
        return base + _al_penalty(constraint_T(x), take(lam_T_rows, lane),
                                  take(mu_rows, lane), is_eq_T)

    return Problem(dynamics=dynamics, cost=cost, final_cost=final_cost,
                   state_dim=(problem.state_dim + 1
                              if problem.state_dim is not None else None),
                   control_dim=problem.control_dim,
                   name=problem.name + "_al",
                   batch_trailing=problem.batch_trailing)


@highest_precision
def al_solve(problem: Problem, x0: torch.Tensor, u_init: torch.Tensor,
             constraint: Callable, constraint_T: Optional[Callable] = None,
             equality_mask=None, equality_mask_T=None,
             config: ILQRConfig = DEFAULT_CONFIG,
             al_config: ALConfig = ALConfig(), device=None) -> ALResult:
    """Solve ``min cost s.t. c(x_k, u_k) <= 0 (or == 0), c_T(x_N) <= 0``.

    ``x0 [*L, n]`` is the initial STATE (the inner trajectories are rolled
    out from it every outer iteration), ``u_init [*L, T, m]``; leading axes
    solve a batch of scenarios, each with its own multipliers and penalty.
    ``constraint``/``constraint_T`` are per-scenario callables (``x [n],
    u [m] -> [p]``); where ``problem.batch_trailing`` promises that the
    problem's callables take trailing batch axes, the constraints must take
    them too (``x [n, ...] -> [p, ...]``), and the augmented problem is then
    called on whole batches without ``torch.func.vmap``.
    ``equality_mask [p]`` (bool) marks equality rows of ``constraint``
    (default: all inequalities).  Runs on ``device`` (default: the card).
    """

    device = resolve_device(device)
    x0, u_init = x0.to(device), u_init.to(device)
    dtype = x0.dtype
    lead = x0.shape[:-1]
    T, m = u_init.shape[-2], u_init.shape[-1]
    n = x0.shape[-1]
    lanes = math.prod(lead)
    per_batch = _exact_lanes(dtype, T)
    if per_batch < 1:
        # Past the bound the step coordinate rounds, and the cost would read
        # a neighbouring step's multipliers.
        raise ValueError(
            f"al_solve: one scenario of T={T} steps numbers the step "
            f"coordinate past the integers that {dtype} holds exactly "
            f"(T + 1 must be below {round(2 / torch.finfo(dtype).eps)}); "
            "solve it in float64")
    if lanes > per_batch:
        # Sub-batches below the bound, each numbering its steps from 0.
        x0_f = x0.reshape(lanes, n)
        u_f = u_init.expand(lead + (T, m)).reshape(lanes, T, m)
        parts = [al_solve(problem, x0_f[i:i + per_batch],
                          u_f[i:i + per_batch], constraint, constraint_T,
                          equality_mask, equality_mask_T, config, al_config,
                          device)
                 for i in range(0, lanes, per_batch)]
        return ALResult(*(torch.cat(f, dim=0).reshape(lead + f[0].shape[1:])
                          for f in zip(*parts)))
    kw = dict(dtype=dtype, device=device)

    # Constraint dimensions from one call on zero tensors.
    p = constraint(torch.zeros((n,), **kw), torch.zeros((m,), **kw)).shape[0]
    pT = (constraint_T(torch.zeros((n,), **kw)).shape[0]
          if constraint_T is not None else 1)   # a dummy row, never used
    is_eq = (torch.zeros((p,), dtype=torch.bool, device=device)
             if equality_mask is None
             else torch.as_tensor(equality_mask, device=device))
    is_eq_T = (torch.zeros((pT,), dtype=torch.bool, device=device)
               if equality_mask_T is None
               else torch.as_tensor(equality_mask_T, device=device))

    trailing = problem.batch_trailing

    def constraint_values(xs, us):
        c = over_leading(constraint, xs[..., :-1, :], us,
                         trailing=trailing)                    # [*L, T, p]
        if constraint_T is not None:
            cT = over_leading(constraint_T, xs[..., -1, :],
                              trailing=trailing)               # [*L, pT]
        else:
            cT = torch.full(lead + (pT,), -1.0, **kw)          # satisfied
        return c, cT

    def max_violation(c, cT):
        return torch.maximum(
            torch.amax(_violation(c, is_eq), dim=(-2, -1)),
            torch.amax(_violation(cT, is_eq_T), dim=-1))

    us = u_init.expand(lead + (T, m))
    lam = torch.zeros(lead + (T, p), **kw)
    lam_T = torch.zeros(lead + (pT,), **kw)
    mu = torch.full(lead, al_config.mu0, **kw)
    prev_viol = torch.full(lead, float("inf"), **kw)
    inner_iters = torch.zeros(lead, dtype=torch.int32, device=device)
    inner_status = torch.full(lead, int(Status.RUNNING), dtype=torch.int32,
                              device=device)
    done = torch.zeros(lead, dtype=torch.bool, device=device)
    ran = torch.zeros(lead, dtype=torch.int32, device=device)
    k0 = (torch.arange(lanes, device=device).reshape(lead) * T).to(dtype)
    x0_aug = torch.cat([x0, k0[..., None]], dim=-1)

    for _ in range(al_config.max_outer):
        if bool(torch.all(done)):
            break   # every lane frozen: further iterations change nothing
        prob_al = _augment_problem(
            problem, constraint, constraint_T, lam.reshape(lanes * T, p),
            lam_T.reshape(lanes, pT), mu.reshape(lanes), is_eq, is_eq_T, T)
        xs_aug = rollout(functools.partial(problem_dynamics, prob_al),
                         x0_aug, us)
        res = solve(prob_al, xs_aug, us, config=config, device=device)

        xs_new = res.xs[..., :-1]
        us_new = res.us
        c, cT = constraint_values(xs_new, us_new)
        viol = max_violation(c, cT)

        # Dual ascent (projected for inequality rows), then penalty update.
        lam_new = lam + mu[..., None, None] * c
        lam_new = torch.where(is_eq, lam_new, torch.clamp(lam_new, min=0.0))
        lam_new = torch.clamp(lam_new, -al_config.lam_max, al_config.lam_max)
        lam_T_new = lam_T + mu[..., None] * cT
        lam_T_new = torch.where(is_eq_T, lam_T_new,
                                torch.clamp(lam_T_new, min=0.0))
        lam_T_new = torch.clamp(lam_T_new, -al_config.lam_max,
                                al_config.lam_max)

        feasible = viol <= al_config.constraint_tol
        slow = viol > al_config.viol_decrease * prev_viol
        mu_new = torch.where(
            torch.logical_and(~feasible, slow),
            torch.clamp(mu * al_config.mu_scale, max=al_config.mu_max), mu)
        done_now = torch.logical_and(
            feasible, res.status != int(Status.LINESEARCH_FAILED))

        # Freeze a lane once it is done.
        upd = ~done
        us = lane_where(upd, us_new, us)
        lam = lane_where(upd, lam_new, lam)
        lam_T = lane_where(upd, lam_T_new, lam_T)
        mu = torch.where(upd, mu_new, mu)
        prev_viol = torch.where(upd, viol, prev_viol)
        inner_iters = inner_iters + torch.where(
            upd, res.iterations, torch.zeros_like(res.iterations))
        inner_status = torch.where(upd, res.status, inner_status)
        done = torch.logical_or(done, done_now)
        ran = ran + upd.to(torch.int32)

    xs = rollout(functools.partial(problem_dynamics, problem), x0, us)
    cost = total_cost(problem, xs, us)
    c, cT = constraint_values(xs, us)
    viol = max_violation(c, cT)
    status = torch.where(
        viol <= al_config.constraint_tol, int(Status.CONVERGED),
        torch.where(inner_status == int(Status.LINESEARCH_FAILED),
                    int(Status.LINESEARCH_FAILED),
                    int(Status.MAX_ITER))).to(torch.int32)
    return ALResult(
        xs=xs, us=us, cost=cost, max_violation=viol, outer_iterations=ran,
        inner_iterations=inner_iters, status=status, lam=lam, lam_T=lam_T,
        mu=mu)
