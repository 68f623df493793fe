"""Receding-horizon MPC.

Counterpart of ``ilqr_tpu/parallel/mpc.py``.  The reference has no MPC loop
— ``fit`` is a single offline solve.  This module runs warm-started
receding-horizon replanning: a loop over control steps, each solving an
H-step iLQR problem warm-started by shifting the previous plan, applying
the first control and advancing the (simulated) plant.  A batch of
scenarios is the same loop on leading batch axes (where the JAX package
vmaps it); with ``backward_backend="pallas"`` each replan's backward pass
then launches the CUDA kernel's batch-first entry.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import torch

from ilqr_tpu_torch.config import DEFAULT_CONFIG, ILQRConfig, Status
from ilqr_tpu_torch.precision import highest_precision, resolve_device
from ilqr_tpu_torch.problem import (Problem, over_leading, problem_dynamics,
                                    rollout)
from ilqr_tpu_torch.solver import solve


class MPCResult(NamedTuple):
    xs: torch.Tensor          # [*L, n_steps+1, n] closed-loop states
    us: torch.Tensor          # [*L, n_steps, m] applied controls
    costs: torch.Tensor       # [*L, n_steps] planned cost at each replan
    iterations: torch.Tensor  # [*L, n_steps] iLQR iterations per replan
    statuses: torch.Tensor    # [*L, n_steps] solver status per replan


@highest_precision
def mpc_run(problem: Problem, x0: torch.Tensor, horizon: int, n_steps: int,
            config: ILQRConfig = DEFAULT_CONFIG,
            plant_dynamics: Optional[Callable] = None,
            u_init: Optional[torch.Tensor] = None, device=None) -> MPCResult:
    """Run ``n_steps`` of receding-horizon control from ``x0 [*L, n]``.

    ``plant_dynamics`` (per scenario; defaults to the model dynamics)
    advances the true system — pass a different function to simulate model
    mismatch.  Warm start: the previous plan shifted by one step, last
    control held; a replan that ends ``LINESEARCH_FAILED`` falls back to
    the warm-start plan.  Runs on ``device`` (default: the card).
    """

    device = resolve_device(device)
    x0 = x0.to(device)
    lead = x0.shape[:-1]
    if plant_dynamics is None:
        plant = functools.partial(problem_dynamics, problem)
    else:
        plant = functools.partial(over_leading, plant_dynamics)
    m = u_init.shape[-1] if u_init is not None else problem.control_dim
    assert m is not None, "problem.control_dim or u_init required"

    us_warm = (u_init.to(device).expand(lead + (horizon, m))
               if u_init is not None
               else torch.zeros(lead + (horizon, m), dtype=x0.dtype,
                                device=device))
    x = x0
    xs, us, costs, iters, statuses = [x0], [], [], [], []
    for _ in range(n_steps):
        xs_warm = rollout(functools.partial(problem_dynamics, problem), x,
                          us_warm)
        result = solve(problem, xs_warm, us_warm, config=config,
                       device=device)
        ok = result.status != int(Status.LINESEARCH_FAILED)
        plan = torch.where(ok[..., None, None], result.us, us_warm)
        u_apply = plan[..., 0, :]
        x = plant(x, u_apply)
        us_warm = torch.cat([plan[..., 1:, :], plan[..., -1:, :]], dim=-2)
        xs.append(x)
        us.append(u_apply)
        costs.append(result.cost)
        iters.append(result.iterations)
        statuses.append(result.status)
    return MPCResult(xs=torch.stack(xs, dim=-2), us=torch.stack(us, dim=-2),
                     costs=torch.stack(costs, dim=-1),
                     iterations=torch.stack(iters, dim=-1),
                     statuses=torch.stack(statuses, dim=-1))


def make_mpc_runner(problem: Problem, horizon: int, n_steps: int,
                    config: ILQRConfig = DEFAULT_CONFIG, device=None):
    """``run(x0) -> MPCResult`` with everything else baked in; ``x0`` may
    carry leading batch axes."""

    device = resolve_device(device)

    def run(x0):
        return mpc_run(problem, x0, horizon, n_steps, config, device=device)

    return run


def batch_mpc_run(problem: Problem, x0s: torch.Tensor, horizon: int,
                  n_steps: int, config: ILQRConfig = DEFAULT_CONFIG,
                  device=None) -> MPCResult:
    """Scenario-batched MPC: ``x0s [B, n]`` → MPCResult with a leading
    batch axis (:func:`mpc_run` on the batch)."""

    return mpc_run(problem, x0s, horizon, n_steps, config, device=device)
