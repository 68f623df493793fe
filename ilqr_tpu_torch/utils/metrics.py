"""Structured per-iteration metrics.

Counterpart of ``ilqr_tpu/utils/metrics.py``.  The reference's entire
observability story is two print statements (src/forward_pass.jl:167
prints iteration/cost; :83-85 spams the line search).  Here a fixed-length
loop of ``config.max_iter`` iterations records a structured trace — cost,
step size, backtracks, convergence quantity, regularization, status — for
every iteration, on the device, with no host round trip but the loop's.

The iteration body is the shared :func:`ilqr_tpu_torch.step.ilqr_step` —
exactly the body ``solver.solve`` runs — so the traced solver cannot drift
from the plain one.  Leading batch axes of the inputs give a trace per
scenario (``[*L, max_iter]`` fields), where the JAX package vmaps.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ilqr_tpu_torch.config import DEFAULT_CONFIG, ILQRConfig
from ilqr_tpu_torch.precision import highest_precision, resolve_device
from ilqr_tpu_torch.problem import Problem, total_cost
from ilqr_tpu_torch.solver import SolverResult
from ilqr_tpu_torch.step import (finalize_status, ilqr_step, initial_state,
                                 make_scalar_engine)


class IterationTrace(NamedTuple):
    """Per-iteration metrics, each ``[*L, max_iter]`` (padded after
    termination).  ``valid`` marks rows of iterations that actually ran."""

    cost: torch.Tensor
    alpha: torch.Tensor
    backtracks: torch.Tensor
    du_sq: torch.Tensor
    dV1: torch.Tensor
    reg: torch.Tensor
    status: torch.Tensor
    valid: torch.Tensor


@highest_precision
def solve_with_trace(problem: Problem, x_init: torch.Tensor,
                     u_init: torch.Tensor,
                     x_ref: Optional[torch.Tensor] = None,
                     config: ILQRConfig = DEFAULT_CONFIG, device=None):
    """Like :func:`ilqr_tpu_torch.solver.solve` but also returns an
    :class:`IterationTrace`.

    Runs exactly ``config.max_iter`` steps (the JAX package's fixed-length
    scan); iterations after termination are frozen by the step's RUNNING
    mask and marked invalid.  Prefer :func:`solve` when the trace is not
    needed and ``max_iter`` is large.  Runs on ``device`` (default: the
    card).
    """

    device = resolve_device(device)
    x_init, u_init = x_init.to(device), u_init.to(device)
    if x_ref is not None:
        x_ref = x_ref.to(device)
    dtype = x_init.dtype
    engine = make_scalar_engine(problem, x_ref, config)

    state = initial_state(x_init, u_init, config,
                          lane_shape=x_init.shape[:-2])
    nan = torch.full((), float("nan"), dtype=dtype, device=device)
    rows = []
    for _ in range(config.max_iter):
        state, aux = ilqr_step(engine, config, state)
        rows.append(IterationTrace(
            cost=torch.where(aux.valid, aux.cost, nan),
            alpha=aux.alpha, backtracks=aux.backtracks, du_sq=aux.du_sq,
            dV1=aux.dV1, reg=aux.reg, status=aux.status, valid=aux.valid))
    trace = IterationTrace(*(torch.stack(col, dim=-1) for col in zip(*rows)))

    status = finalize_status(state.status)
    cost = torch.where(
        torch.isinf(state.prev_cost),
        total_cost(problem, state.xs, state.us, x_ref).to(dtype),
        state.prev_cost)
    result = SolverResult(
        xs=state.xs, us=state.us, cost=cost, iterations=state.iteration,
        status=status, reg=state.reg, alpha=state.alpha, du_sq=state.du_sq,
    )
    return result, trace
