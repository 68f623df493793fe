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


def over_leading(fn: Callable, *args: torch.Tensor, trailing: bool = False):
    """A per-scenario ``fn`` applied over the leading axes of its arguments.

    Every argument is a point with one trailing axis (``x [*L, n]``,
    ``u [*L, m]``) and all share the leading shape ``L`` of the first.  The
    outputs carry ``L`` first (``[*L, ...]``) and the first argument's float
    type.  This is the port's written-out ``jax.vmap`` of a per-scenario
    callable; with no leading axes ``fn`` is called as it is.

    ``trailing=True`` promises that ``fn`` takes trailing batch axes
    (``Problem.batch_trailing``): the leading axes are moved behind the
    point's own and ``fn`` is called once, outside any ``vmap``.  Otherwise
    the leading axes are flattened into one and ``fn`` runs under
    ``torch.func.vmap``.  The cast back to the input's type undoes the
    float64 that ``torch.func`` makes of ``0-d float32 <op> Python float``
    inside a ``vmap`` of forward-mode derivatives (``ROADMAP.md`` C4, C8).
    """

    lead = args[0].shape[:-1]
    nl = len(lead)
    dtype = args[0].dtype
    if nl == 0:
        out = fn(*args)

        def back(o):
            return o.to(dtype)
    elif trailing:
        out = fn(*(a.movedim(-1, 0) for a in args))

        def back(o):
            k = o.ndim - nl
            return o.movedim(tuple(range(k)), tuple(range(nl, nl + k))).to(
                dtype)
    else:
        out = torch.func.vmap(fn)(*(a.reshape((-1,) + a.shape[nl:])
                                    for a in args))

        def back(o):
            return o.reshape(lead + o.shape[1:]).to(dtype)
    return tuple(map(back, out)) if isinstance(out, tuple) else back(out)


def problem_dynamics(problem: Problem, x: torch.Tensor,
                     u: torch.Tensor) -> torch.Tensor:
    """One step of ``problem.dynamics`` on ``x [*L, n]``, ``u [*L, m]``."""

    return over_leading(problem.dynamics, x, u,
                        trailing=problem.batch_trailing)


@highest_precision
def rollout(dynamics: Callable, x0: torch.Tensor,
            us: torch.Tensor) -> torch.Tensor:
    """Roll the dynamics forward from ``x0`` under open-loop controls ``us``.

    Returns the state trajectory ``[T+1, n]``.  ``dynamics`` is any
    callable of ``(x, u)``; for leading batch axes pass a batched one, e.g.
    ``functools.partial(problem_dynamics, problem)`` with ``x0 [*L, n]``,
    ``us [*L, T, m]`` (then ``[*L, T+1, n]``)."""

    xs = [x0]
    for t in range(us.shape[-2]):
        xs.append(dynamics(xs[-1], us[..., t, :]))
    return torch.stack(xs, dim=-2)


def step_costs(problem: Problem, xs: torch.Tensor, us: torch.Tensor,
               x_ref: Optional[torch.Tensor] = None):
    """Per-timestep running costs ``[*L, T]`` and terminal cost ``[*L]`` of
    ``xs [*L, T+1, n]``, ``us [*L, T, m]`` (no leading axes: ``[T]`` and a
    scalar).

    Replicates src/forward_pass.jl:182-196: the running cost sees the state
    *offset by the reference trajectory* (``L(x_i - r_i, u_i)``, :190) while
    the terminal cost sees the raw final state (:192).  When ``x_ref`` is
    ``None`` the offset is zero.  ``total_cost == sum(steps) + final``; the
    high-resolution line-search acceptance (``config.exact_ls_delta``)
    differences these per-step values instead of the rounded totals."""

    xs_run = xs[..., :-1, :]
    if x_ref is not None:
        xs_run = xs_run - x_ref[..., : xs_run.shape[-2], :]
    trailing = problem.batch_trailing
    return (over_leading(problem.cost, xs_run, us, trailing=trailing),
            over_leading(problem.final_cost, xs[..., -1, :],
                         trailing=trailing))


@highest_precision
def total_cost(problem: Problem, xs: torch.Tensor, us: torch.Tensor,
               x_ref: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Total trajectory cost ``[*L]`` (offset semantics of
    :func:`step_costs`)."""

    steps, final = step_costs(problem, xs, us, x_ref)
    return torch.sum(steps, dim=-1) + final
