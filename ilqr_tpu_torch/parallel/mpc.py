"""Receding-horizon MPC.

Counterpart of ``ilqr_tpu/parallel/mpc.py``.  The reference has no MPC loop
— ``fit`` is a single offline solve.  This module runs warm-started
receding-horizon replanning: a loop over control steps, each solving an
H-step iLQR problem warm-started by shifting the previous plan, applying
the first control and advancing the (simulated) plant.  A batch of
scenarios is the same loop on leading batch axes (where the JAX package
vmaps it); with ``backward_backend="pallas"`` each replan's backward pass
then launches the CUDA kernel's batch-first entry.
:func:`batch_mpc_run_chunked` runs a fleet in host chunks with a
checkpoint file to resume from.
"""

from __future__ import annotations

import functools
import os
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
        x, us_warm, (u_apply, cost, it, status) = _replan(
            problem, x, us_warm, config, plant, device)
        xs.append(x)
        us.append(u_apply)
        costs.append(cost)
        iters.append(it)
        statuses.append(status)
    return MPCResult(xs=torch.stack(xs, dim=-2), us=torch.stack(us, dim=-2),
                     costs=torch.stack(costs, dim=-1),
                     iterations=torch.stack(iters, dim=-1),
                     statuses=torch.stack(statuses, dim=-1))


def _replan(problem: Problem, x, us_warm, config: ILQRConfig, plant,
            device):
    """One control step of every scenario: solve from the warm start, fall
    back to it where the solve ends ``LINESEARCH_FAILED``, apply the plan's
    first control to the plant and shift the plan.  Returns ``(x_next,
    us_warm_next, (u_apply, cost, iterations, status))``."""

    xs_warm = rollout(functools.partial(problem_dynamics, problem), x,
                      us_warm)
    result = solve(problem, xs_warm, us_warm, config=config, device=device)
    ok = result.status != int(Status.LINESEARCH_FAILED)
    plan = torch.where(ok[..., None, None], result.us, us_warm)
    u_apply = plan[..., 0, :]
    x_next = plant(x, u_apply)
    us_next = torch.cat([plan[..., 1:, :], plan[..., -1:, :]], dim=-2)
    return x_next, us_next, (u_apply, result.cost, result.iterations,
                             result.status)


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


def batch_mpc_run_chunked(problem: Problem, x0s: torch.Tensor, horizon: int,
                          n_steps: int,
                          config: ILQRConfig = DEFAULT_CONFIG,
                          step_chunk: int = 10,
                          checkpoint_path: Optional[str] = None,
                          checkpoint_every: int = 1,
                          on_chunk=None, device=None) -> MPCResult:
    """Checkpointable scenario-batched MPC for long fleet runs.

    Same results as :func:`batch_mpc_run`, but the ``n_steps`` control
    steps run in host chunks of ``step_chunk`` steps, and (with
    ``checkpoint_path``) the whole run state — the MPC carry ``(x,
    us_warm)`` and every per-step output so far, as numpy host accumulators
    with the JAX package's keys and dtypes (``step`` int64, ``x``,
    ``us_warm``, ``xs``, ``us``, ``costs`` in the input's type, ``iters``
    and ``statuses`` int32) — is saved every ``checkpoint_every`` chunks and
    after the last with :func:`ilqr_tpu_torch.utils.checkpoint.
    save_solver_state`.  If ``checkpoint_path`` exists when the run starts,
    the run RESUMES from the saved step; a file of the JAX package's
    ``batch_mpc_run_chunked`` resumes here too.

    ``n_steps`` must be divisible by ``step_chunk``.  ``on_chunk(step)``
    streams progress; return True to stop early (the partial result is
    checkpointed and returned, the remaining steps zero-filled).  Runs on
    ``device`` (default: the card); the result lies there.
    """

    import numpy as np

    from ilqr_tpu_torch.utils.checkpoint import (load_solver_state,
                                                 save_solver_state)

    assert n_steps % step_chunk == 0, (n_steps, step_chunk)
    device = resolve_device(device)
    B, n = x0s.shape
    m = problem.control_dim
    n_chunks = n_steps // step_chunk
    plant = functools.partial(problem_dynamics, problem)

    # Host accumulators, preallocated so that the checkpoint has a fixed
    # structure at every step.
    x0_host = x0s.detach().cpu().numpy()
    dtype = x0_host.dtype
    state = {
        "step": np.zeros((), np.int64),
        "x": x0_host,
        "us_warm": np.zeros((B, horizon, m), dtype),
        "xs": np.zeros((n_steps, B, n), dtype),
        "us": np.zeros((n_steps, B, m), dtype),
        "costs": np.zeros((n_steps, B), dtype),
        "iters": np.zeros((n_steps, B), np.int32),
        "statuses": np.zeros((n_steps, B), np.int32),
    }
    if checkpoint_path is not None and os.path.exists(checkpoint_path):
        state = load_solver_state(checkpoint_path, state)

    def host(t):
        return t.detach().cpu().numpy()

    start_chunk = int(state["step"]) // step_chunk
    x = torch.as_tensor(state["x"]).to(device)
    us_warm = torch.as_tensor(state["us_warm"]).to(device)
    for ci in range(start_chunk, n_chunks):
        lo = ci * step_chunk
        for k in range(lo, lo + step_chunk):
            x, us_warm, (u_apply, cost, it, status) = _replan(
                problem, x, us_warm, config, plant, device)
            state["xs"][k] = host(x)
            state["us"][k] = host(u_apply)
            state["costs"][k] = host(cost)
            state["iters"][k] = host(it)
            state["statuses"][k] = host(status)
        hi = lo + step_chunk
        state["x"] = host(x)
        state["us_warm"] = host(us_warm)
        state["step"] = np.int64(hi)
        if checkpoint_path is not None and (
                (ci + 1 - start_chunk) % checkpoint_every == 0
                or ci == n_chunks - 1):
            save_solver_state(checkpoint_path, state)
        if on_chunk is not None and on_chunk(hi):
            break

    xs = np.concatenate([x0_host[None], state["xs"]], axis=0)

    def out(a):
        return torch.as_tensor(np.ascontiguousarray(np.moveaxis(a, 1, 0))
                               ).to(device)

    return MPCResult(xs=out(xs), us=out(state["us"]),
                     costs=out(state["costs"]),
                     iterations=out(state["iters"]),
                     statuses=out(state["statuses"]))
