"""Analytic planar 2-link manipulator — the framework's golden model.

Counterpart of ``ilqr_tpu/models/two_link.py``: the reference's canonical
test problem (test/2_link_example/2_link_helper_functions.jl) with a
closed-form inertia matrix, a closed-form Coriolis matrix, RK4 integration,
and joint-space quadratic costs targeting the inverse kinematics of a
workspace tool location.  Everything is safe under ``torch.func``
``vmap``/``jacfwd``.

Every function indexes its arguments along the LEADING axis only
(``state[i]``, ``u[i]``) and stacks or sums over that axis, so it also runs
directly on tensors with trailing batch axes (``state [4, ...]``).  The
batch-last engine uses that (``Problem.batch_trailing``) to keep
``torch.func.vmap`` out of its rollout loops.

Parity notes (these matter for the ``|u - u_ref|_inf < 1e-3`` target):

* The reference's Coriolis loop reads ``for k in length(θ)``
  (2_link_helper_functions.jl:42-44).  In Julia, iterating the *integer*
  ``length(θ)`` yields the single value ``2`` — so only the last joint's
  velocity contributes, not the full Christoffel sum.  That behavior is
  replicated by default (``faithful_coriolis=True``); the correct full sum
  is an option.
* The reference computes a ``velocity_penalty`` in ``immediate_cost`` and
  then does not add it to the returned cost
  (2_link_helper_functions.jl:94-99) — the cost is joint-error + torque
  only.  Matched.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ilqr_tpu_torch.problem import Problem


@dataclasses.dataclass(frozen=True)
class TwoLinkParams:
    """Link parameters (values from 2_link_helper_functions.jl:4-16)."""

    l1: float = math.sqrt(2.0) / 2.0
    l2: float = math.sqrt(2.0) / 2.0
    m1: float = 1.0
    m2: float = 1.0
    dt: float = 0.01
    target_x: float = 0.6
    target_y: float = -0.5
    faithful_coriolis: bool = True  # replicate the reference's k-loop quirk

    @property
    def r1(self):
        return 0.5 * self.l1

    @property
    def r2(self):
        return 0.5 * self.l2

    @property
    def Iz1(self):
        return self.m1 * self.l1 ** 2 / 12.0

    @property
    def Iz2(self):
        return self.m2 * self.l2 ** 2 / 12.0

    # Standard 2-link inertia constants (2_link_helper_functions.jl:11-13).
    @property
    def alpha(self):
        return self.Iz1 + self.Iz2 + self.m1 * self.r1 ** 2 + self.m2 * (
            self.l1 ** 2 + self.r2 ** 2)

    @property
    def beta(self):
        return self.m2 * self.l1 * self.r2

    @property
    def delta(self):
        return self.Iz2 + self.m2 * self.r2 ** 2


def inverse_kinematics(params: TwoLinkParams, target):
    """Elbow-up IK for a workspace point (2_link_helper_functions.jl:19-26)."""

    x, y = target[0], target[1]
    l1, l2 = params.l1, params.l2
    c2 = (x ** 2 + y ** 2 - l1 ** 2 - l2 ** 2) / (2.0 * l1 * l2)
    q2 = torch.acos(c2)
    q1 = torch.atan2(y, x) - torch.atan2(l2 * torch.sin(q2),
                                         l1 + l2 * torch.cos(q2))
    return torch.stack([q1, q2])


def forward_kinematics(params: TwoLinkParams, theta):
    """Joint and tool positions, for visualization and workspace costs."""

    j1 = torch.stack([params.l1 * torch.cos(theta[0]),
                      params.l1 * torch.sin(theta[0])])
    tool = j1 + torch.stack([
        params.l2 * torch.cos(theta[0] + theta[1]),
        params.l2 * torch.sin(theta[0] + theta[1]),
    ])
    return j1, tool


def inertia_matrix(params: TwoLinkParams, theta):
    """M(theta) [2, 2] (2_link_helper_functions.jl:29-33)."""

    a, b, d = params.alpha, params.beta, params.delta
    c2 = torch.cos(theta[1])
    d_ = torch.full_like(c2, d)
    return torch.stack([
        torch.stack([a + 2.0 * b * c2, d + b * c2]),
        torch.stack([d + b * c2, d_]),
    ])


def inertia_matrix_grad(params: TwoLinkParams, theta):
    """Closed-form ``dM[a, b, c] = dM[a,b]/dtheta[c]`` [2, 2, 2].

    Only ``theta[1]`` enters M (through ``cos``), so the gradient has one
    nonzero slice.  With the closed form the dynamics is plain first-order
    trig under forward-mode AD instead of a nested jacobian.
    """

    b = params.beta
    s2 = torch.sin(theta[1])
    zero = torch.zeros_like(s2)
    # [a, b] entries of dM/dtheta2.
    d2 = torch.stack([
        torch.stack([-2.0 * b * s2, -b * s2]),
        torch.stack([-b * s2, zero]),
    ])
    return torch.stack([torch.zeros_like(d2), d2], dim=2)


def coriolis_matrix(params: TwoLinkParams, theta, theta_dot):
    """C(theta, theta_dot) [2, 2].

    ``dM[a, b, c] = dM[a,b]/dtheta[c]`` (closed form) — the same layout the
    reference gets from reshaping ForwardDiff's jacobian column-major
    (2_link_helper_functions.jl:37-38).  With ``faithful_coriolis`` only
    ``k = n-1`` contributes (see module docstring); otherwise the full
    Christoffel-style sum over k is used.
    """

    dM = inertia_matrix_grad(params, theta)  # [2,2,2]
    n = theta.shape[0]
    ks = [n - 1] if params.faithful_coriolis else list(range(n))
    rows = []
    for i in range(n):
        row = []
        for j in range(n):
            cij = 0.0
            for k in ks:
                cij = cij + 0.5 * (dM[k, i, j] + dM[j, i, k]
                                   - dM[i, k, j]) * theta_dot[k]
            row.append(cij)
        rows.append(torch.stack(row))
    return torch.stack(rows)


def continuous_dynamics(params: TwoLinkParams, state, u):
    """xdot = [theta_dot; M^{-1}(-C theta_dot + u)]
    (2_link_helper_functions.jl:53-69), fully scalar-expanded for n=2.

    Why scalar instead of a 2x2 solve: hand-expanding the algebra —
    explicit determinant inverse, componentwise Coriolis — keeps the whole
    dynamics (and its forward-mode duals) as elementwise operations over
    whatever batch axes trail ``state`` and ``u``.  Entries of ``dM`` that
    are identically zero are the Python float ``0.0``, so they cost no
    tensor operation; adding them changes no value.
    """

    t2 = state[1]
    td = (state[2], state[3])
    c2 = torch.cos(t2)
    s2 = torch.sin(t2)
    al, be, de = params.alpha, params.beta, params.delta
    m11 = al + 2.0 * be * c2
    m12 = de + be * c2
    m22 = de

    # dM[a][b][c] = dM[a,b]/dtheta[c] (inertia_matrix_grad's closed form;
    # only theta2 enters M).
    g = -be * s2
    zero = 0.0
    dM = ((
        (zero, 2.0 * g), (zero, g)), (
        (zero, g), (zero, zero)))

    ks = (1,) if params.faithful_coriolis else (0, 1)

    def C(i, j):
        cij = 0.0
        for k in ks:
            cij = cij + 0.5 * (dM[k][i][j] + dM[j][i][k] - dM[i][k][j]) * td[k]
        return cij

    g1 = -(C(0, 0) * td[0] + C(0, 1) * td[1]) + u[0]
    g2 = -(C(1, 0) * td[0] + C(1, 1) * td[1]) + u[1]
    det = m11 * m22 - m12 * m12
    qdd1 = (m22 * g1 - m12 * g2) / det
    qdd2 = (m11 * g2 - m12 * g1) / det
    return torch.stack([td[0], td[1], qdd1, qdd2])


def make_dynamics(params: TwoLinkParams):
    """RK4 discrete dynamics (2_link_helper_functions.jl:72-78)."""

    dt = params.dt

    def dynamics(x, u):
        k1 = dt * continuous_dynamics(params, x, u)
        k2 = dt * continuous_dynamics(params, x + k1 / 2.0, u)
        k3 = dt * continuous_dynamics(params, x + k2 / 2.0, u)
        k4 = dt * continuous_dynamics(params, x + k3, u)
        return x + (k1 + 2.0 * k2 + 2.0 * k3 + k4) / 6.0

    return dynamics


def make_two_link_problem(params: TwoLinkParams = TwoLinkParams(),
                          analytic_cost_derivatives: bool = True) -> Problem:
    """The reference's swing-up problem: drive joints to the IK of the tool
    target, penalizing torque (2_link_helper_functions.jl:82-108).

    The costs are exact quadratics, so by default the Problem carries
    analytic (constant-Hessian) quadratization hooks — the solver then
    skips the per-step cost AD entirely.  ``analytic_cost_derivatives=
    False`` falls back to autodiff quadratization (identical results).
    """

    target_joints64 = inverse_kinematics(
        params, torch.tensor([params.target_x, params.target_y],
                             dtype=torch.float64)).tolist()
    cache = {}

    def target_joints(x):
        """The joint target on ``x``'s device and dtype, shaped ``[2, 1,
        ...]`` to broadcast against ``x[:2]``.  Made once per (device,
        dtype): a constant rebuilt on every call would be a host-to-device
        copy inside the hot loops."""

        key = (x.device, x.dtype)
        if key not in cache:
            cache[key] = torch.tensor(target_joints64, dtype=x.dtype,
                                      device=x.device)
        return cache[key].reshape((-1,) + (1,) * (x.ndim - 1))

    def immediate_cost(x, u):
        n = x.shape[0] // 2
        joint_err = target_joints(x) - x[:n]
        # Reference computes a velocity penalty here and drops it (:94-99).
        return torch.sum(joint_err ** 2, dim=0) + torch.sum(u ** 2, dim=0)

    def final_cost(x):
        n = x.shape[0] // 2
        joint_err = target_joints(x) - x[:n]
        return torch.sum(joint_err ** 2, dim=0)

    def _xx_block(x):
        n = x.shape[0] // 2
        kw = dict(dtype=x.dtype, device=x.device)
        return torch.diag(torch.cat([torch.full((n,), 2.0, **kw),
                                     torch.zeros((n,), **kw)]))

    kw = {}
    if analytic_cost_derivatives:
        # Per-scenario hooks (x [n], u [m]); constants are built on the
        # input's device and dtype.
        def cost_quadratization(x, u):
            n = x.shape[0] // 2
            joint_err = target_joints(x) - x[:n]
            q = torch.sum(joint_err ** 2) + torch.sum(u ** 2)
            qx = torch.cat([-2.0 * joint_err, torch.zeros_like(x[n:])])
            ru = 2.0 * u
            Qxx = _xx_block(x)
            Pux = torch.zeros((u.shape[0], x.shape[0]), dtype=x.dtype,
                              device=x.device)
            Ruu = 2.0 * torch.eye(u.shape[0], dtype=x.dtype, device=x.device)
            return q, qx, ru, Qxx, Pux, Ruu

        def final_cost_quadratization(x):
            n = x.shape[0] // 2
            joint_err = target_joints(x) - x[:n]
            q = torch.sum(joint_err ** 2)
            qx = torch.cat([-2.0 * joint_err, torch.zeros_like(x[n:])])
            return q, qx, _xx_block(x)

        kw = dict(cost_quadratization=cost_quadratization,
                  final_cost_quadratization=final_cost_quadratization)

    return Problem(
        dynamics=make_dynamics(params),
        cost=immediate_cost,
        final_cost=final_cost,
        state_dim=4,
        control_dim=2,
        name="two_link",
        batch_trailing=True,
        **kw,
    )
