"""Control box constraints by smooth squashing.

Counterpart of ``ilqr_tpu/constraints.py``.  The reference solver is
unconstrained — URDF effort limits are parsed but never enforced
(SURVEY.md §2.2).  This module adds the standard smooth-squashing treatment
as a *problem transform*, leaving the solver untouched: the solver works
over unbounded pre-controls ``v`` with

    u = mid + half * tanh(v),   mid = (u_max + u_min)/2, half = (u_max - u_min)/2

so every iterate — every line-search trial rollout included — satisfies
``u_min < u < u_max`` strictly.  The result is just another ``Problem``,
so it works with every engine of the port.

Typical use::

    base = make_two_link_problem()
    prob, to_u, to_v = box_constrained(base, u_min=-5.0, u_max=5.0)
    result = solve(prob, xs0, to_v(us0))
    us = to_u(result.us)                 # feasible torques
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch

from ilqr_tpu_torch.problem import Problem


def box_constrained(problem: Problem, u_min, u_max,
                    margin: float = 1e-6) -> Tuple[Problem, Callable, Callable]:
    """Wrap ``problem`` so that controls are squashed into ``(u_min,
    u_max)``.

    ``u_min``/``u_max`` are scalars or ``[m]`` arrays.  Returns
    ``(squashed_problem, to_u, to_v)``: ``to_u(v)`` maps pre-controls to
    feasible controls and ``to_v(u)`` is its inverse (controls are clipped
    ``margin`` inside the box first so that ``arctanh`` is finite — use it
    on initial guesses).  Both act on the last axis (``[..., m]``).

    The squashed problem's cost and dynamics are the originals composed with
    ``to_u``; the base problem's analytic dynamics Jacobians and running-cost
    quadratization are dropped (they are in u-space) and autodiff takes the
    chain rule through the squash, as in the JAX package.  Its callables take
    trailing batch axes where the base problem's do (``batch_trailing``).
    The bounds are cast to the controls' type at every call, so a float32
    problem stays float32 under ``torch.func`` (``ROADMAP.md`` C4).
    """

    u_min = torch.as_tensor(u_min, dtype=torch.float64)
    u_max = torch.as_tensor(u_max, dtype=torch.float64)
    mid = 0.5 * (u_max + u_min)
    half = 0.5 * (u_max - u_min)

    def _like(t, v, axis):
        """``t`` in ``v``'s type, along ``v``'s control axis ``axis``."""

        t = t.to(dtype=v.dtype, device=v.device)
        if t.ndim == 0:
            return t
        return t.reshape((-1,) + (1,) * (v.ndim - 1)) if axis == 0 else t

    def squash(v, axis):
        return _like(mid, v, axis) + _like(half, v, axis) * torch.tanh(v)

    def to_u(v):
        return squash(v, -1)

    def to_v(u):
        h = _like(half, u, -1)
        span = torch.where(h > 0, h, torch.ones_like(h))
        lim = 1.0 - margin
        z = torch.clamp((u - _like(mid, u, -1)) / span, -lim, lim)
        return torch.arctanh(z)

    # The problem's callables see ``v [m]``, or ``v [m, ...]`` where the base
    # problem takes trailing batch axes: the control axis is the first.
    def dynamics(x, v):
        return problem.dynamics(x, squash(v, 0))

    def cost(x, v):
        return problem.cost(x, squash(v, 0))

    squashed = dataclasses.replace(
        problem,
        dynamics=dynamics,
        cost=cost,
        name=problem.name + "_box",
        dynamics_jacobians=None,
        cost_quadratization=None,
        final_cost_quadratization=problem.final_cost_quadratization,
    )
    return squashed, to_u, to_v
