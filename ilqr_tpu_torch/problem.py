"""The problem contract: three pure callables.

Mirrors the reference's entire user-facing contract
(src/forward_pass.jl:113-144):

* ``dynamics(x, u) -> x_next`` — discrete step, ``x: [n]``, ``u: [m]``;
* ``cost(x, u) -> scalar`` — running cost at one step;
* ``final_cost(x) -> scalar`` — terminal cost.

All three are pure functions of ``torch`` tensors, safe under
``torch.func.vmap``/``jacfwd``/``grad``: no in-place updates, no
data-dependent Python control flow.  Counterpart of ``ilqr_tpu/problem.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ilqr_tpu_torch.precision import highest_precision


@dataclasses.dataclass(frozen=True)
class Problem:
    """An optimal-control problem: dynamics + running cost + terminal cost.

    ``state_dim``/``control_dim`` are optional metadata used by helpers.
    """

    dynamics: Callable  # (x[n], u[m]) -> x_next[n]
    cost: Callable      # (x[n], u[m]) -> scalar
    final_cost: Callable  # (x[n]) -> scalar
    state_dim: Optional[int] = None
    control_dim: Optional[int] = None
    name: str = "problem"
    # Optional analytic derivative overrides (framework extension — the
    # reference always differentiates on the fly).  When provided, the
    # solver uses these instead of autodiff; they must return exactly what
    # the autodiff path would:
    #   dynamics_jacobians(x, u) -> (A [n,n], B [n,m])
    #   cost_quadratization(x, u) -> (q, qx [n], ru [m], Qxx [n,n],
    #                                 Pux [m,n], Ruu [m,m])
    #   final_cost_quadratization(x) -> (q, qx [n], Qxx [n,n])
    dynamics_jacobians: Optional[Callable] = None
    cost_quadratization: Optional[Callable] = None
    final_cost_quadratization: Optional[Callable] = None
    #   dynamics_hessians(x, u) -> Fzz [n, n+m, n+m] (z = (x, u)) — only
    #   consulted under ILQRConfig(ddp=True); autodiff otherwise.
    dynamics_hessians: Optional[Callable] = None
    # The port's one addition.  True promises that ``dynamics``, ``cost``,
    # ``final_cost`` and, where given, ``dynamics_jacobians`` also accept
    # trailing batch axes — ``x [n, ...]``, ``u [m, ...]`` giving
    # ``[n, ...]`` / ``[...]`` / ``([n, n, ...], [n, m, ...])`` — as
    # functions do that only index ``x[i]``/``u[i]`` and stack or sum over
    # the leading axis.  (The cost quadratization hooks stay per-scenario.)
    # The batch-last engine then calls them directly instead of through
    # ``torch.func.vmap``, which spares the per-operation cost of vmap in
    # the T-step rollout loops.  Same values either way.
    batch_trailing: bool = False

    def __hash__(self):
        return hash((id(self.dynamics), id(self.cost), id(self.final_cost),
                     id(self.dynamics_jacobians),
                     id(self.cost_quadratization),
                     id(self.final_cost_quadratization),
                     id(self.dynamics_hessians), self.name))


@highest_precision
def rollout(dynamics: Callable, x0: torch.Tensor,
            us: torch.Tensor) -> torch.Tensor:
    """Roll the dynamics forward from ``x0`` under open-loop controls ``us``.

    Returns the state trajectory ``[T+1, n]``."""

    xs = [x0]
    for t in range(us.shape[0]):
        xs.append(dynamics(xs[-1], us[t]))
    return torch.stack(xs, dim=0)


def step_costs(problem: Problem, xs: torch.Tensor, us: torch.Tensor,
               x_ref: Optional[torch.Tensor] = None):
    """Per-timestep running costs ``[T]`` and terminal cost (scalar).

    Replicates src/forward_pass.jl:182-196: the running cost sees the state
    *offset by the reference trajectory* (``L(x_i - r_i, u_i)``, :190) while
    the terminal cost sees the raw final state (:192).  When ``x_ref`` is
    ``None`` the offset is zero.  ``total_cost == sum(steps) + final``; the
    high-resolution line-search acceptance (``config.exact_ls_delta``)
    differences these per-step values instead of the rounded totals."""

    xs_run = xs[:-1]
    if x_ref is not None:
        xs_run = xs_run - x_ref[: xs_run.shape[0]]
    return torch.func.vmap(problem.cost)(xs_run, us), problem.final_cost(xs[-1])


@highest_precision
def total_cost(problem: Problem, xs: torch.Tensor, us: torch.Tensor,
               x_ref: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Total trajectory cost (offset semantics of :func:`step_costs`)."""

    steps, final = step_costs(problem, xs, us, x_ref)
    return torch.sum(steps) + final
