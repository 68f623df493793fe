"""Local approximation layer: whole-horizon derivatives in one batched sweep.

Counterpart of ``ilqr_tpu/derivatives.py``.  The reference computes every
Jacobian/Hessian one timestep at a time inside the backward loop
(src/backward_pass.jl:339-351); here the whole horizon is differentiated at
once.  Forward-mode (``jacfwd``) is used for the dynamics and
forward-over-reverse for the Hessians, as in the JAX package.

Every function takes optional leading batch axes in front of the JAX
function's own: ``xs [*L, T, n]``, ``us [*L, T, m]`` give ``As [*L, T, n,
n]``, and so on — the port's written-out ``jax.vmap`` over scenarios
(``problem.over_leading``).  Results keep the inputs' float type.

A problem whose callables take trailing batch axes
(``Problem.batch_trailing``) has its dynamics differentiated without a
per-scenario ``vmap`` (:func:`jacobians_trailing`): the leading axes move
behind the state's own and one ``jvp`` per input direction covers them all.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
from torch.func import grad, jacfwd, jvp, vmap

from ilqr_tpu_torch.problem import over_leading


def jacobians_trailing(dynamics: Callable):
    """``(x [n, *L], u [m, *L]) -> (A [n, n, *L], B [n, m, *L])`` by
    forward-mode AD of a dynamics that takes trailing batch axes: one
    ``jvp`` per input direction, vmapped over the ``n + m`` basis tangents
    (what ``jacfwd`` does per scenario, without a ``vmap`` over scenarios —
    every ``x[i]`` keeps its lane axes, so nothing is promoted to float64,
    see ``ROADMAP.md`` C4)."""

    def jac(x, u):
        n, m = x.shape[0], u.shape[0]
        eye = torch.eye(n + m, dtype=x.dtype, device=x.device)
        lanes = (1,) * (x.ndim - 1)
        tx = eye[:, :n].reshape((n + m, n) + lanes).expand((n + m,) + x.shape)
        tu = eye[:, n:].reshape((n + m, m) + lanes).expand((n + m,) + u.shape)
        J = vmap(lambda a, b: jvp(dynamics, (x, u), (a, b))[1])(tx, tu)
        J = J.movedim(0, 1)                 # [n, n + m, *L]
        return J[:, :n], J[:, n:]

    return jac


def linearize_dynamics(dynamics: Callable, xs: torch.Tensor,
                       us: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Linearize a per-scenario ``dynamics`` around every point at once.

    ``xs [*L, T, n]``, ``us [*L, T, m]`` → ``(As [*L, T, n, n], Bs [*L, T,
    n, m])`` with ``A_k = df/dx``, ``B_k = df/du`` (reference:
    src/backward_pass.jl:25-40, batched)."""

    return over_leading(jacfwd(dynamics, argnums=(0, 1)), xs, us)


def quadratize_running_cost(cost: Callable, xs: torch.Tensor,
                            us: torch.Tensor):
    """Second-order expansion of the running cost along the whole horizon.

    Returns ``(q [*L, T], qx [*L, T, n], ru [*L, T, m], Qxx [*L, T, n, n],
    Pux [*L, T, m, n], Ruu [*L, T, m, m])`` — the (q_i, 𝐪_i, 𝐫_i, 𝐐_i,
    𝐏_i, 𝐑_i) of src/backward_pass.jl:81-109, with ``Pux = d²L/du dx``.
    One gradient and one forward-over-reverse Hessian over the concatenated
    ``z = (x, u)`` yield all five blocks."""

    n = xs.shape[-1]

    def cost_z(z):
        return cost(z[:n], z[n:])

    grad_z = grad(cost_z)
    hess_z = jacfwd(grad_z)

    def one_point(x, u):
        z = torch.cat([x, u])
        gz = grad_z(z)
        Hz = hess_z(z)
        return (cost_z(z), gz[:n], gz[n:], Hz[:n, :n], Hz[n:, :n],
                Hz[n:, n:])

    return over_leading(one_point, xs, us)


def quadratize_final_cost(final_cost: Callable, x_final: torch.Tensor):
    """Terminal expansion ``(q_N [*L], q_N_x [*L, n], Q_N [*L, n, n])``.

    Reference: src/backward_pass.jl:134-153."""

    fgrad = grad(final_cost)

    def one_point(x):
        return final_cost(x), fgrad(x), jacfwd(fgrad)(x)

    return over_leading(one_point, x_final)


# ---------------------------------------------------------------------------
# Problem-aware sweeps: use analytic overrides when the Problem carries them.
# ---------------------------------------------------------------------------

def problem_linearize(problem, xs, us):
    """Whole-horizon ``(As, Bs)`` for a Problem — the user's analytic
    ``dynamics_jacobians`` when provided, autodiff otherwise; either one
    called on trailing batch axes where the problem promises it."""

    trailing = problem.batch_trailing
    if problem.dynamics_jacobians is not None:
        return over_leading(problem.dynamics_jacobians, xs, us,
                            trailing=trailing)
    if trailing:
        return over_leading(jacobians_trailing(problem.dynamics), xs, us,
                            trailing=True)
    return linearize_dynamics(problem.dynamics, xs, us)


def problem_quadratize_running(problem, xs, us):
    """Whole-horizon running-cost quadratization for a Problem (the hook
    is per-scenario, as in the JAX package)."""

    if problem.cost_quadratization is not None:
        return over_leading(problem.cost_quadratization, xs, us)
    return quadratize_running_cost(problem.cost, xs, us)


def problem_quadratize_final(problem, x_final):
    """Terminal quadratization for a Problem."""

    if problem.final_cost_quadratization is not None:
        return over_leading(problem.final_cost_quadratization, x_final)
    return quadratize_final_cost(problem.final_cost, x_final)


def dynamics_hessians(dynamics: Callable, xs: torch.Tensor,
                      us: torch.Tensor) -> torch.Tensor:
    """Second-order dynamics tensor along the whole horizon (DDP extension).

    Returns ``Fzz [*L, T, n, n+m, n+m]`` with ``Fzz[t, k, i, j] = d2 f_k /
    dz_i dz_j`` at ``z = (x_t, u_t)``, symmetrized against roundoff drift —
    the tensor the full DDP recursion contracts with the value gradient
    (``ILQRConfig(ddp=True)``; the reference is pure iLQR and has no
    counterpart).  Memory is ``T n (n+m)^2`` values a scenario."""

    n = xs.shape[-1]

    def f_z(z):
        return dynamics(z[:n], z[n:])

    hess = jacfwd(jacfwd(f_z))

    def one(x, u):
        H = hess(torch.cat([x, u]))
        return 0.5 * (H + H.transpose(-1, -2))

    return over_leading(one, xs, us)


def problem_dynamics_hessians(problem, xs, us):
    """Whole-horizon ``Fzz`` for a Problem — the user's analytic
    ``dynamics_hessians`` when provided, autodiff otherwise.

    A user-supplied tensor is used as given, NOT symmetrized, while the
    autodiff path symmetrizes: this mirrors the JAX package
    (``ilqr_tpu/derivatives.py:151-152``, ``ROADMAP.md`` C2), so a hook
    must return a symmetric tensor to match it."""

    if problem.dynamics_hessians is not None:
        return over_leading(problem.dynamics_hessians, xs, us)
    return dynamics_hessians(problem.dynamics, xs, us)
