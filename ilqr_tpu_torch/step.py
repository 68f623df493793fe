"""The single shared iLQR iteration body.

One solver iteration — backward pass, stationarity gate, line-searched
forward pass, convergence/status bookkeeping, trajectory adoption — is the
same algorithm whatever the layout.  Solve loops run :func:`ilqr_step`; layout
(scalar vs batch-last lanes) is the engine's concern, not an algorithm
fork.  Counterpart of ``ilqr_tpu/step.py``, logic carried over verbatim.

Semantics replicated from the reference ``fit`` loop
(src/forward_pass.jl:148-179):

* convergence when ``sum((u_new - u)^2) <= tol`` after an accepted step
  (:171);
* on the converging iteration the pre-update iterate is returned (the
  ``break`` at :171 runs before the update at :174-175) under
  ``config.reference_return_semantics``;
* a rejected line search leaves the iterate untouched.

Framework extensions (all default-off or masked per lane): stationarity
test ``|dV1| <= tol_grad + tol_grad_rel * |cost|`` that skips the
line-search ladder, adaptive Tikhonov regularization, per-lane Status.

Dtypes are those of the JAX package so that solver state crosses between
the two (``ilqr_tpu_torch.convert``): ``iteration`` and ``status`` are
int32, every other lane value has the trajectories' float type, and a
Python-scalar branch of a ``where`` never widens it.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ilqr_tpu_torch.config import ILQRConfig, Status


class StepState(NamedTuple):
    """Solver loop carry.  Scalar per-lane fields are 0-d tensors in a
    per-scenario engine and ``[B]`` lane vectors in the batch-last engine;
    trajectories are ``[T+1, n]`` / ``[T, m]`` (batch-last: trailing ``B``)."""

    xs: torch.Tensor
    us: torch.Tensor
    prev_cost: torch.Tensor
    iteration: torch.Tensor  # int32: iterations this lane actually ran
    status: torch.Tensor     # int32 Status
    reg: torch.Tensor
    alpha: torch.Tensor
    du_sq: torch.Tensor


class StepAux(NamedTuple):
    """Per-iteration observables (one row of a solve trace)."""

    cost: torch.Tensor        # candidate cost from the line search (inf if skipped)
    alpha: torch.Tensor
    backtracks: torch.Tensor
    du_sq: torch.Tensor
    dV1: torch.Tensor         # predicted linear decrease from the backward pass
    reg: torch.Tensor         # regularization used this iteration (pre-update)
    status: torch.Tensor      # status after this iteration
    valid: torch.Tensor       # bool: lane was RUNNING when the iteration started


class StepEngine(NamedTuple):
    """Layout-specific primitives the shared step body is written against.

    ``backward(xs, us, reg) -> (duffs, Ks, dV1, dV2)`` where
        ``dV1 = sum_t duff_t . Qu_t`` and
        ``dV2 = 0.5 sum_t duff_t . Quu_t duff_t`` (the expected cost
        change at step size alpha is ``alpha dV1 + alpha^2 dV2``);
    ``forward(xs, us, duffs, Ks, prev_cost, active, dV1, dV2, alpha_init)
        -> (xs, us, cost, accepted, alpha, backtracks)`` where ``accepted``
        must be False for lanes with ``active=False`` (``dV1``/``dV2``
        feed the optional expected-decrease acceptance test);
    ``du_sq(us_new, us_old) -> per-lane scalar``
    ``select(mask, new, old)`` — per-lane ``where`` for lane-shaped values;
    ``select_traj(mask, new, old)`` — ``where`` broadcast over a trajectory.
    """

    backward: Callable
    forward: Callable
    du_sq: Callable
    select: Callable
    select_traj: Callable


def ilqr_step(engine: StepEngine, config: ILQRConfig,
              state: StepState) -> tuple[StepState, StepAux]:
    """One iLQR iteration for every lane still RUNNING.

    Lanes not RUNNING are frozen: their state passes through unchanged and
    their ``aux.valid`` is False.  Pure function of the state.
    :func:`ilqr_step` == ``ilqr_step_apply(..., *ilqr_step_backward(...))``.
    """

    duffs, Ks, dV1, dV2 = ilqr_step_backward(engine, state)
    return ilqr_step_apply(engine, config, state, duffs, Ks, dV1, dV2)


def ilqr_step_backward(engine: StepEngine, state: StepState):
    """Phase 1: the backward Riccati pass on the current iterate.

    Returns ``(duffs, Ks, dV1, dV2)`` — everything the forward phase
    needs."""

    return engine.backward(state.xs, state.us, state.reg)


def ilqr_step_apply(engine: StepEngine, config: ILQRConfig,
                    state: StepState, duffs, Ks, dV1, dV2
                    ) -> tuple[StepState, StepAux]:
    """Phase 2: stationarity gate, line-searched forward pass, and all
    convergence/status bookkeeping, given phase 1's outputs for the SAME
    ``state``."""

    running = state.status == int(Status.RUNNING)

    # First-order stationarity: predicted linear decrease ~ 0.  A stationary
    # iterate has no improving alpha, so skip the line-search ladder rather
    # than burning max_backtracks rollouts proving it.
    if config.tol_grad > 0.0 or config.tol_grad_rel > 0.0:
        thresh = config.tol_grad + config.tol_grad_rel * torch.where(
            torch.isfinite(state.prev_cost), torch.abs(state.prev_cost), 0.0)
        stationary = torch.abs(dV1) <= thresh
    else:
        stationary = torch.zeros_like(running)

    active = torch.logical_and(running, ~stationary)
    if config.ls_alpha_warm_start:
        # One rung above the lane's last accepted alpha, capped at alpha0
        # (initial_state seeds state.alpha = alpha0, so iteration 1 is
        # unchanged; a failed ladder resets the carry below).
        alpha_init = torch.clamp(state.alpha / config.alpha_factor,
                                 max=config.alpha0)
    else:
        alpha_init = None
    fxs, fus, fcost, accepted, falpha, fbts = engine.forward(
        state.xs, state.us, duffs, Ks, state.prev_cost, active, dV1, dV2,
        alpha_init)

    du_sq = engine.du_sq(fus, state.us)
    converged = torch.logical_or(
        torch.logical_and(accepted, du_sq <= config.tol), stationary)
    ls_failed = torch.logical_and(~accepted, ~converged)

    if config.adaptive_reg:
        raise_reg = ls_failed
        if config.reg_backtrack_trigger > 0:
            # A step that only accepted deep in the ladder is a sign the
            # local model overshoots; steer reg up so the next step accepts
            # near alpha = 1 (Tassa et al. 2012 schedule).  Under the
            # warm-started ladder the backtrack count no longer encodes
            # depth (a crawling lane accepts at rung 0), so the trigger
            # tests the accepted alpha itself: bts >= t with an alpha0
            # start is exactly alpha <= alpha0 * factor^t (half-rung
            # tolerance keeps the discrete comparison robust).
            if config.ls_alpha_warm_start:
                alpha_thresh = config.alpha0 * (
                    config.alpha_factor
                    ** (config.reg_backtrack_trigger - 0.5))
                deep_accept = torch.logical_and(accepted,
                                                falpha < alpha_thresh)
            else:
                deep_accept = fbts >= config.reg_backtrack_trigger
            raise_reg = torch.logical_or(raise_reg, deep_accept)
        reg_new = torch.where(
            raise_reg,
            torch.clamp(state.reg * config.reg_scale, max=config.reg_max),
            torch.clamp(state.reg / config.reg_scale, min=config.reg_min),
        )
        # A failed line search is retried at higher reg; it is only fatal
        # once the schedule is exhausted.
        fatal_ls = torch.logical_and(ls_failed, state.reg >= config.reg_max)
    else:
        reg_new = state.reg
        fatal_ls = ls_failed

    status_new = torch.where(
        fatal_ls, int(Status.LINESEARCH_FAILED),
        torch.full_like(state.status, int(Status.RUNNING)))
    status_new = torch.where(converged, int(Status.CONVERGED), status_new)

    # Adopt the candidate unless the line search rejected it, or the
    # reference's return semantics keep the pre-update iterate on the
    # converging iteration.
    keep_old = torch.logical_or(
        ~accepted,
        converged if config.reference_return_semantics
        else torch.zeros_like(converged))
    adopt = torch.logical_and(running, ~keep_old)

    xs = engine.select_traj(adopt, fxs, state.xs)
    us = engine.select_traj(adopt, fus, state.us)
    prev_cost = engine.select(torch.logical_and(running, accepted),
                              fcost, state.prev_cost)
    status = engine.select(running, status_new, state.status)
    reg = engine.select(running, reg_new, state.reg)
    if config.ls_alpha_warm_start:
        # Carry only ACCEPTED alphas; a failed ladder's exhausted alpha is
        # stale (reg just changed the local model) — restart at alpha0.
        alpha_carry = engine.select(
            accepted, falpha, torch.full_like(falpha, config.alpha0))
    else:
        alpha_carry = falpha
    alpha = engine.select(running, alpha_carry, state.alpha)
    du_sq_out = engine.select(running, du_sq, state.du_sq)
    iteration = state.iteration + running.to(torch.int32)

    new_state = StepState(
        xs=xs, us=us, prev_cost=prev_cost, iteration=iteration,
        status=status, reg=reg, alpha=alpha, du_sq=du_sq_out,
    )
    aux = StepAux(
        cost=fcost, alpha=falpha, backtracks=fbts, du_sq=du_sq, dV1=dV1,
        reg=state.reg, status=status, valid=running,
    )
    return new_state, aux


def initial_state(xs, us, config: ILQRConfig, lane_shape=()) -> StepState:
    """The canonical loop init: infinite prev_cost (first forward pass
    accepts alpha=1 unconditionally, src/forward_pass.jl:154), RUNNING
    status, static initial reg."""

    kw = dict(dtype=xs.dtype, device=xs.device)
    ikw = dict(dtype=torch.int32, device=xs.device)
    return StepState(
        xs=xs,
        us=us,
        prev_cost=torch.full(lane_shape, float("inf"), **kw),
        iteration=torch.zeros(lane_shape, **ikw),
        status=torch.full(lane_shape, int(Status.RUNNING), **ikw),
        reg=torch.full(lane_shape, config.reg, **kw),
        alpha=torch.full(lane_shape, config.alpha0, **kw),
        du_sq=torch.full(lane_shape, float("inf"), **kw),
    )


def finalize_status(status):
    """Lanes still RUNNING when the loop ends hit the iteration cap."""

    return torch.where(status == int(Status.RUNNING), int(Status.MAX_ITER),
                       status)


def lane_where(mask, new, old):
    """Per-lane ``where`` of the per-scenario layout: ``mask [*L]`` broadcast
    over the trailing axes of ``new`` (``[*L]``, ``[*L, T, m]``, ...)."""

    return torch.where(mask.reshape(mask.shape + (1,) * (new.ndim - mask.ndim)),
                       new, old)


def make_scalar_engine(problem, x_ref, config: ILQRConfig) -> StepEngine:
    """The per-scenario engine.  Every lane-shaped value has the leading
    batch shape ``[*L]`` (``()`` for one scenario) and trajectories are
    ``[*L, T+1, n]`` / ``[*L, T, m]``: the port's written-out ``jax.vmap``
    of the JAX engine.

    Raises ``NotImplementedError`` on ``parallel_alpha_block > 0``: the
    parallel-alpha ladder exists only in the fused engine, and the JAX
    per-scenario engine ignores the flag silently, so a run that sets it
    would measure the sequential ladder (``ROADMAP.md`` C17; refused as the
    fused engine refuses what it ignores, C1).  ``derivative_chunk`` is
    ignored here, as in the JAX package: it bounds the memory of the fused
    engine's derivatives and changes no result.
    """

    if config.parallel_alpha_block > 0:
        raise NotImplementedError(
            "parallel_alpha_block > 0 is not implemented by the per-scenario "
            "engine of ilqr_tpu_torch (solver.solve, "
            "make_batch_solver(engine='vmap'), MPC, al_solve); the fused "
            "engine (make_batch_solver(engine='fused')) has it")

    from ilqr_tpu_torch.backward import backward_pass
    from ilqr_tpu_torch.forward import forward_pass

    def backward(xs, us, reg):
        b = backward_pass(problem, xs, us, config, reg=reg)
        return b.duffs, b.Ks, b.dV1, b.dV2

    def forward(xs, us, duffs, Ks, prev_cost, active, dV1, dV2,
                alpha_init=None):
        f = forward_pass(problem, xs, us, duffs, Ks, prev_cost, x_ref,
                         config, active=active, dV1=dV1, dV2=dV2,
                         alpha_init=alpha_init)
        return f.xs, f.us, f.cost, f.accepted, f.alpha, f.backtracks

    return StepEngine(
        backward=backward,
        forward=forward,
        du_sq=lambda a, b: torch.sum((a - b) ** 2, dim=(-2, -1)),
        select=torch.where,
        select_traj=lane_where,
    )
