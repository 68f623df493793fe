"""Cost-function library.

Counterpart of ``ilqr_tpu/costs.py``.  The reference signals the intent of
a reusable cost library in its dead ``src/cost_functions.jl`` (excluded
from the module at src/iLQR.jl:9); here those builders — and the
diagonal-weighted quadratic forms of the RBD example
(test/RBD_2_link_example/RBD_helper_functions.jl:85-116) — are plain
per-scenario torch functions that compose.

Weights and targets are cast to the argument's type at every call, and
every scalar weight enters as a 0-d tensor of that type: a Python float
would widen float32 to float64 under ``torch.func`` (``ROADMAP.md`` C4, C8).
"""

from __future__ import annotations

from typing import Callable

import torch


def _const(t):
    """A weight or target, kept in float64 until a call casts it."""

    return None if t is None else torch.as_tensor(t, dtype=torch.float64)


def _like(t, x):
    return t.to(dtype=x.dtype, device=x.device)


def _apply(W, v):
    """``v' diag(W) v`` for a 1-D ``W``, ``v' W v`` for a matrix."""

    W = _like(W, v)
    return v @ (W * v) if W.ndim == 1 else v @ W @ v


def _offset(x, target):
    if target is None:
        return x
    tgt = _like(target, x)
    return tgt - x[: tgt.numel()]


def quadratic_tracking_cost(Q, R, target=None):
    """``l(x, u) = (target - x)^T Q (target - x) + u^T R u``.

    ``Q``/``R`` may be full matrices or 1-D arrays (interpreted diagonal) —
    the diagonal-weighted form of RBD_helper_functions.jl:85-103.
    """

    Q, R, target = _const(Q), _const(R), _const(target)

    def cost(x, u):
        return _apply(Q, _offset(x, target)) + _apply(R, u)

    return cost


def quadratic_final_cost(Q, target=None, weight: float = 1.0):
    """``phi(x) = weight * (target - x)^T Q (target - x)``
    (RBD_helper_functions.jl:106-116, terminal weight 1e5 in the example)."""

    Q, target, weight = _const(Q), _const(target), _const(weight)

    def final_cost(x):
        return _like(weight, x) * _apply(Q, _offset(x, target))

    return final_cost


def effort_cost(weight: float = 1.0):
    """``l(x, u) = weight * sum(u^2)`` — the reference's
    ``simple_immediate_cost`` (src/cost_functions.jl:34-54)."""

    weight = _const(weight)

    def cost(x, u):
        return _like(weight, u) * torch.sum(u * u)

    return cost


def workspace_target_final_cost(forward_kinematics: Callable, target,
                                weight: float = 1.0):
    """Weighted squared distance of a body point to a workspace target — the
    reference's ``simple_final_cost`` (src/cost_functions.jl:5-27), with the
    kinematics a differentiable torch callable ``forward_kinematics(x) ->
    point [3] (or [2])``."""

    target, weight = _const(target), _const(weight)

    def final_cost(x):
        d = forward_kinematics(x) - _like(target, x)
        return _like(weight, x) * torch.sum(d * d)

    return final_cost


def add_costs(*costs: Callable):
    """Sum several running costs ``l(x, u)`` into one (in the order given,
    as the JAX function adds them to 0.0)."""

    def cost(x, u):
        total = costs[0](x, u)
        for c in costs[1:]:
            total = total + c(x, u)
        return total

    return cost
