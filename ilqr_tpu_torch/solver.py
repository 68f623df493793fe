"""The per-scenario solve loop and a reference-compatible ``fit``.

Counterpart of ``ilqr_tpu/solver.py``, the equivalent of the reference's
``fit`` (src/forward_pass.jl:148-179).  Replicated semantics:

* initial ``prev_cost = Inf`` (:154), so the first forward pass accepts
  alpha = 1 on any finite cost;
* convergence when ``sum((u_new - u)^2) <= tol`` (:171);
* on the converging iteration the reference ``break``s *before* adopting
  the new trajectory (:171 vs :174-175), returning the previous iterate —
  matched under ``config.reference_return_semantics`` (default).

Framework extensions over the reference: bounded line search with a
``LINESEARCH_FAILED`` status, optional adaptive regularization, per-scenario
status flags, iteration metrics.

The JAX solve is written for one scenario and scaled by ``jax.vmap``; here
it takes optional leading batch axes (``x_init [*L, T+1, n]``) and its loop
does what ``vmap`` of a ``lax.while_loop`` does: it runs while any lane is
RUNNING below ``max_iter``, every pass is computed for all lanes, and a lane
whose own condition is false keeps its state.  Batched, the backward pass
of ``backward_backend="pallas"`` runs the CUDA kernel's batch-first entry.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ilqr_tpu_torch.config import DEFAULT_CONFIG, ILQRConfig, Status
from ilqr_tpu_torch.precision import highest_precision, resolve_device
from ilqr_tpu_torch.problem import Problem, total_cost
from ilqr_tpu_torch.step import (StepState, finalize_status, ilqr_step,
                                 initial_state, lane_where,
                                 make_scalar_engine)


class SolverResult(NamedTuple):
    xs: torch.Tensor          # [T+1, n] solution state trajectory
    us: torch.Tensor          # [T, m] solution controls
    cost: torch.Tensor        # scalar: cost of (xs, us)
    iterations: torch.Tensor  # int32: backward/forward iterations performed
    status: torch.Tensor      # int32: ilqr_tpu_torch.Status value
    reg: torch.Tensor         # final regularization (== config.reg unless adaptive)
    alpha: torch.Tensor       # last accepted step size
    du_sq: torch.Tensor       # last sum((u_new - u)^2) (convergence quantity)

    @property
    def converged(self):
        return self.status == int(Status.CONVERGED)


@highest_precision
def solve(problem: Problem, x_init: torch.Tensor, u_init: torch.Tensor,
          x_ref: Optional[torch.Tensor] = None,
          config: ILQRConfig = DEFAULT_CONFIG, device=None) -> SolverResult:
    """Solve the trajectory-optimization problem by iLQR.

    ``x_init [*L, T+1, n]`` is the full initial state trajectory (the
    linearization point of the first backward pass — the reference's API,
    src/forward_pass.jl:148; :func:`ilqr_tpu_torch.problem.rollout` builds
    one from an initial state), ``u_init [*L, T, m]``, ``x_ref`` the
    reference trajectory of the running cost (``[T+1, n]`` or ``[*L, T+1,
    n]``).  Every field of the result has the leading shape ``L``.

    The iteration body is the shared :func:`ilqr_tpu_torch.step.ilqr_step`
    on the per-scenario engine.  Runs on ``device`` (default: the card;
    inputs are moved there).
    """

    device = resolve_device(device)
    x_init, u_init = x_init.to(device), u_init.to(device)
    if x_ref is not None:
        x_ref = x_ref.to(device)
    dtype = x_init.dtype
    engine = make_scalar_engine(problem, x_ref, config)

    state = initial_state(x_init, u_init, config,
                          lane_shape=x_init.shape[:-2])
    # One host synchronization per test of the condition.
    while True:
        cond = torch.logical_and(state.status == int(Status.RUNNING),
                                 state.iteration < config.max_iter)
        if not bool(torch.any(cond)):
            break
        new = ilqr_step(engine, config, state)[0]
        state = StepState(*(lane_where(cond, a, b)
                            for a, b in zip(new, state)))

    status = finalize_status(state.status)
    cost = torch.where(
        torch.isinf(state.prev_cost),
        total_cost(problem, state.xs, state.us, x_ref).to(dtype),
        state.prev_cost)
    return SolverResult(
        xs=state.xs,
        us=state.us,
        cost=cost,
        iterations=state.iteration,
        status=status,
        reg=state.reg,
        alpha=state.alpha,
        du_sq=state.du_sq,
    )


def make_solver(problem: Problem, config: ILQRConfig = DEFAULT_CONFIG,
                with_ref: bool = False, device=None):
    """``solve_fn(x_init, u_init[, x_ref]) -> SolverResult`` with the
    problem, config and device baked in.  Leading batch axes of the
    arguments solve a batch of scenarios (where the JAX package vmaps the
    returned function)."""

    device = resolve_device(device)
    if with_ref:
        def solve_fn(x_init, u_init, x_ref):
            return solve(problem, x_init, u_init, x_ref, config, device)
    else:
        def solve_fn(x_init, u_init):
            return solve(problem, x_init, u_init, None, config, device)

    return solve_fn


def fit(x_init, u_init, dynamicsf, immediate_cost, final_cost,
        x_traj=None, max_iter: int = 100, tol: float = 1e-6,
        config: Optional[ILQRConfig] = None, device=None):
    """Reference-compatible entry point.

    Mirrors ``iLQR.fit(x_init, u_init, dynamicsf, immediate_cost,
    final_cost; x_traj, max_iter, tol)`` (src/forward_pass.jl:148-152) and
    returns ``(xs, us)``.  The three callables are per-scenario, as the
    reference's are; arrays may be numpy or torch.  ``x_traj`` defaults to
    zeros, as in the reference (:151).
    """

    problem = Problem(dynamics=dynamicsf, cost=immediate_cost,
                      final_cost=final_cost)
    cfg = (config or DEFAULT_CONFIG).replace(max_iter=int(max_iter),
                                             tol=float(tol))
    result = solve(problem, torch.as_tensor(x_init), torch.as_tensor(u_init),
                   x_ref=None if x_traj is None else torch.as_tensor(x_traj),
                   config=cfg, device=device)
    return result.xs, result.us
