"""Forward pass: closed-loop rollout + bounded backtracking line search.

Counterpart of ``ilqr_tpu/forward.py``.  Reference behavior
(src/forward_pass.jl:55-93):

* closed-loop update ``u_new = u + alpha*duff + K (x_new - x)`` about the
  previous accepted trajectory (:72-73 — only the feedforward is scaled by
  alpha);
* acceptance is raw cost decrease ``prev_cost - new_cost > 0`` (:79) — and
  since any comparison with NaN is false, NaN rollouts backtrack;
* alpha ladder 1, 1/2, 1/4, … (:66,:82), accepting the *first*
  improvement, but bounded at ``config.max_backtracks`` instead of the
  reference's unbounded ``while true`` (:70).

Leading batch axes (``xs [*L, T+1, n]``, per-lane ``prev_cost [*L]``) are
the port's written-out ``jax.vmap`` of the JAX ``lax.while_loop``: the
ladder runs while any lane's condition holds, every rung is computed for
all lanes, and a lane whose own condition is false keeps its carry — its
rung counter, its alpha and its last tried rollout — unchanged.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ilqr_tpu_torch.config import DEFAULT_CONFIG, ILQRConfig
from ilqr_tpu_torch.ops import smallmat as sm
from ilqr_tpu_torch.precision import highest_precision
from ilqr_tpu_torch.problem import (Problem, problem_dynamics, step_costs,
                                    total_cost)
from ilqr_tpu_torch.step import lane_where


class ForwardResult(NamedTuple):
    xs: torch.Tensor        # [*L, T+1, n] accepted (or last tried) states
    us: torch.Tensor        # [*L, T, m] accepted (or last tried) controls
    cost: torch.Tensor      # [*L] cost of (xs, us)
    accepted: torch.Tensor  # bool [*L]: some alpha decreased the cost
    alpha: torch.Tensor     # [*L] the accepted step size
    backtracks: torch.Tensor  # int32 [*L]: number of rejected alphas


@highest_precision
def closed_loop_rollout(problem: Problem, xs, us, duffs, Ks, alpha,
                        unroll: int = 1):
    """One closed-loop rollout over the horizon (src/forward_pass.jl:71-75);
    ``alpha`` is a scalar or ``[*L]``.  ``unroll`` is accepted for the JAX
    signature and ignored."""

    alpha = torch.as_tensor(alpha, dtype=xs.dtype, device=xs.device)[..., None]
    x_new = xs[..., 0, :]
    xs_new, us_new = [], []
    for t in range(us.shape[-2]):
        u_new = (us[..., t, :] + alpha * duffs[..., t, :]
                 + sm.mv(Ks[..., t, :, :], x_new - xs[..., t, :]))
        xs_new.append(x_new)
        us_new.append(u_new)
        x_new = problem_dynamics(problem, x_new, u_new)
    xs_new.append(x_new)
    return torch.stack(xs_new, dim=-2), torch.stack(us_new, dim=-2)


@highest_precision
def forward_pass(problem: Problem, xs, us, duffs, Ks, prev_cost,
                 x_ref: Optional[torch.Tensor] = None,
                 config: ILQRConfig = DEFAULT_CONFIG,
                 active=None, dV1=None, dV2=None,
                 alpha_init=None) -> ForwardResult:
    """Line-searched forward pass.

    Equivalent of the reference's public ``forward_pass`` (:55) with the
    trajectory-offset total cost of src/forward_pass.jl:182-196.

    ``active`` (bool, scalar or ``[*L]``, default True) gates a lane's whole
    ladder: an inactive lane returns ``accepted=False``, ``backtracks=0``
    and its inputs unchanged.  ``dV1``/``dV2`` (the backward pass's
    expected-decrease coefficients) feed the optional expected-decrease
    test (``config.ls_expected_decrease``, Tassa et al. 2012): a rung is
    accepted only if the achieved decrease is at least ``config.ls_c`` of
    the predicted one.  ``alpha_init`` (per lane) replaces the first rung
    ``config.alpha0`` (``config.ls_alpha_warm_start``).

    A lane whose ladder runs out returns its LAST TRIED rollout and cost
    with ``accepted=False`` (the JAX carry; the batch-last
    ``forward_pass_bl`` keeps the old iterate instead — the step body
    discards a rejected candidate either way).  One host synchronization
    per rung.
    """

    dtype, device = xs.dtype, xs.device
    lead = xs.shape[:-2]
    if active is None:
        active = True
    active = torch.as_tensor(active, device=device).expand(lead)
    use_expected = config.ls_expected_decrease and dV1 is not None

    if config.exact_ls_delta:
        steps_old, final_old = step_costs(problem, xs, us, x_ref)

    def try_alpha(alpha):
        xs_new, us_new = closed_loop_rollout(problem, xs, us, duffs, Ks,
                                             alpha)
        # Acceptance threshold on the achieved decrease: 0 for the
        # reference's any-decrease rule; ls_c * predicted decrease under
        # the expected-decrease test (predicted <= 0 falls back to
        # any-decrease).
        if use_expected:
            exp_impr = -(alpha * dV1 + alpha * alpha * dV2)
            thresh = (config.ls_c * torch.clamp(exp_impr, min=0.0)).to(dtype)
        else:
            thresh = torch.zeros((), dtype=dtype, device=device)
        if config.exact_ls_delta:
            steps_new, final_new = step_costs(problem, xs_new, us_new, x_ref)
            cost = (torch.sum(steps_new, dim=-1) + final_new).to(dtype)
            # Same condition as prev_cost - cost > 0, evaluated as a sum of
            # per-step differences; the first iteration (prev_cost = inf)
            # always accepts.  NaN delta rejects.
            delta = (torch.sum(steps_new - steps_old, dim=-1)
                     + (final_new - final_old)).to(dtype)
            accept = torch.logical_or(torch.isinf(prev_cost), -delta > thresh)
            # Converging-step acceptance: a candidate bitwise identical to
            # the iterate (the gain step underflowed the float32 update) is
            # the step the convergence test fires on; delta for it is
            # re-evaluation noise and is not consulted.
            du_step_sq = torch.sum((us_new - us) ** 2, dim=(-2, -1))
            accept = torch.logical_or(accept, du_step_sq == 0)
            # A FINITE cost is required: an accepted inf would re-arm the
            # isinf(prev_cost) gate forever.
            accept = torch.logical_and(accept, torch.isfinite(cost))
        else:
            cost = total_cost(problem, xs_new, us_new, x_ref).to(dtype)
            # False for NaN cost → backtrack; inf prev_cost → accept.
            accept = (prev_cost - cost) > thresh
        return xs_new, us_new, cost, accept

    k = torch.zeros(lead, dtype=torch.int32, device=device)
    alpha = (torch.full(lead, config.alpha0, dtype=dtype, device=device)
             if alpha_init is None
             else alpha_init.to(dtype).expand(lead).clone())
    accepted = torch.zeros(lead, dtype=torch.bool, device=device)
    xs_c, us_c = xs, us
    cost = torch.full(lead, float("inf"), dtype=dtype, device=device)
    while True:
        run = active & ~accepted & (k < config.max_backtracks)
        if not bool(torch.any(run)):
            break
        xs_new, us_new, cost_new, accept = try_alpha(alpha)
        next_alpha = torch.where(accept, alpha, alpha * config.alpha_factor)
        k = torch.where(run, k + 1, k)
        alpha = torch.where(run, next_alpha, alpha)
        accepted = torch.where(run, accept, accepted)
        xs_c = lane_where(run, xs_new, xs_c)
        us_c = lane_where(run, us_new, us_c)
        cost = torch.where(run, cost_new, cost)
    # backtracks = number of REJECTED alphas: k-1 on acceptance, k on
    # exhaustion, and 0 — not -1 — when the ladder was skipped (k = 0).
    backtracks = torch.where(accepted, torch.clamp(k - 1, min=0), k)
    return ForwardResult(xs=xs_c, us=us_c, cost=cost, accepted=accepted,
                         alpha=alpha, backtracks=backtracks)
