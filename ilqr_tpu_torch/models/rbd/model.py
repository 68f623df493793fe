"""Floating-base arm model on the rigid-body layer — the reference's second
benchmark problem (test/RBD_2_link_example/RBD_helper_functions.jl).
Counterpart of ``ilqr_tpu/models/rbd/model.py``.

State chart (matching the reference's iLQR state, n = 2*nv):

    x = [p (3, MRP attitude), r (3, base position), θ (nj, joints),
         ω (3, body angular vel), v (3, body linear vel), θ̇ (nj)]

The reference integrates base position as ``ṙ = v`` even though the
floating joint's linear velocity is body-frame
(RBD_helper_functions.jl:68 — RigidBodyDynamics.jl would use ṙ = R(q) v);
``reference_kinematics=True`` replicates that, the default uses the correct
rotation.

Layout.  The callables of this module follow the solver's contract — the
state's components on the LEADING axis, ``x [n]``, ``u [m]`` — and also
take any trailing batch axes, ``x [n, ...]``, ``u [m, ...]`` (the
``Problem.batch_trailing`` promise): they move the component axis last,
run the rigid-body layer (which batches over leading dims) and move it
back.  So the batch-last engine calls them on ``[n, B]`` and ``[n, T, B]``
directly and no ``torch.func.vmap`` over scenarios runs.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch

from ilqr_tpu_torch.models.rbd.dynamics import (
    _chol_solve,
    crba_mass_matrix,
    forward_dynamics,
    forward_dynamics_derivatives,
    make_forward_dynamics_analytic_jvp,
)
from ilqr_tpu_torch.models.rbd.rotations import (
    p_from_q,
    pdot_from_w,
    pdot_from_w_jac,
    q_from_p,
    q_from_p_jac,
    quat_to_rotmat,
    quat_to_rotmat_jac,
)
from ilqr_tpu_torch.models.rbd.spatial import block, mv
from ilqr_tpu_torch.models.rbd.urdf import Mechanism, parse_urdf
from ilqr_tpu_torch.ops.linalg import cholesky_small
from ilqr_tpu_torch.problem import Problem

ASSET_DIR = os.path.join(os.path.dirname(__file__), "assets")
TWO_DOF_ARM_URDF = os.path.join(ASSET_DIR, "2Dof_arm.urdf")
SIX_DOF_ARM_URDF = os.path.join(ASSET_DIR, "6Dof_arm.urdf")
# Two 6-DoF arms on one free-flying base (n=36, m=18): 6Dof_arm.urdf's arm
# and a copy of it whose first joint sits at y = -0.5 (assets/README.md).
DUAL_6DOF_ARM_URDF = os.path.join(ASSET_DIR, "dual_6Dof_arm.urdf")
# Five 6-DoF arms on one free-flying base (n=72, m=36): the dual arm and
# three more copies mounted at (-0.5, 0.5, 0), (-0.5, -0.5, 0) and
# (0, 0, 0.5) (assets/README.md).
FIVE_6DOF_ARM_URDF = os.path.join(ASSET_DIR, "five_6Dof_arm.urdf")

def rbd_to_mrp_state(x):
    """[quat(4); rest] → [mrp(3); rest] (RBD_helper_functions.jl:29-33);
    components on the last axis."""

    return torch.cat([p_from_q(x[..., :4]), x[..., 4:]], dim=-1)


def mrp_to_rbd_state(x):
    """[mrp(3); rest] → [quat(4); rest] (RBD_helper_functions.jl:36-41);
    components on the last axis."""

    return torch.cat([q_from_p(x[..., :3]), x[..., 3:]], dim=-1)


def _components_last(fn, n_out_matrix=()):
    """Wrap ``fn(x [..., n], u [..., m])`` (batch dims leading) as a
    function of ``x [n, ...]``, ``u [m, ...]`` (batch dims trailing).
    ``fn`` returns one tensor or a tuple; each result's component axes — one
    for a vector, two where ``n_out_matrix`` says so — move back to the
    front."""

    def back(o, matrix):
        return o.movedim((-2, -1), (0, 1)) if matrix else o.movedim(-1, 0)

    def wrapped(x, u):
        out = fn(x.movedim(0, -1), u.movedim(0, -1))
        if isinstance(out, tuple):
            return tuple(back(o, i in n_out_matrix)
                         for i, o in enumerate(out))
        return back(out, False)

    return wrapped


def _continuous_dynamics_last(mech: Mechanism, reference_kinematics: bool,
                              analytic_derivatives: bool):
    """``ẋ = f_c(x, u)`` with components on the last axis."""

    assert mech.joints[0].joint_type == "floating", (
        "make_rbd_continuous_dynamics expects a floating-base mechanism")
    nj = mech.nv - 6

    if analytic_derivatives:
        fd = make_forward_dynamics_analytic_jvp(mech)
    else:
        def fd(q, v, tau):
            return forward_dynamics(mech, q, v, tau)

    def continuous_dynamics(x, u):
        p = x[..., 0:3]
        r = x[..., 3:6]
        theta = x[..., 6:6 + nj]
        vel = x[..., 6 + nj:]           # [ω(3), v(3), θ̇(nj)]
        omega = vel[..., 0:3]
        v_lin = vel[..., 3:6]

        quat = q_from_p(p)
        q_mech = torch.cat([quat, r, theta], dim=-1)
        vdot = fd(q_mech, vel, u)

        p_dot = pdot_from_w(p, omega)
        if reference_kinematics:
            r_dot = v_lin          # the reference's ṙ = v quirk (:68)
        else:
            r_dot = mv(quat_to_rotmat(quat), v_lin)
        theta_dot = vel[..., 6:]
        return torch.cat([p_dot, r_dot, theta_dot, vdot], dim=-1)

    return continuous_dynamics


def make_rbd_continuous_dynamics(mech: Mechanism,
                                 reference_kinematics: bool = False,
                                 analytic_derivatives: bool = True):
    """The continuous dynamics ``ẋ = f_c(x, u)`` over the MRP state
    (RBD_helper_functions.jl:51-69): chart kinematics rows + forward
    dynamics ``v̇ = M(q)^{-1}(u - bias)``."""

    return _components_last(_continuous_dynamics_last(
        mech, reference_kinematics, analytic_derivatives))


def _rk4_last(continuous_dynamics, dt: float):
    def dynamics(x, u):
        k1 = dt * continuous_dynamics(x, u)
        k2 = dt * continuous_dynamics(x + k1 / 2.0, u)
        k3 = dt * continuous_dynamics(x + k2 / 2.0, u)
        k4 = dt * continuous_dynamics(x + k3, u)
        return x + (k1 + 2.0 * k2 + 2.0 * k3 + k4) / 6.0

    return dynamics


def make_rbd_dynamics(mech: Mechanism, dt: float = 0.01,
                      reference_kinematics: bool = False,
                      analytic_derivatives: bool = True):
    """RK4 discrete dynamics over the MRP state
    (RBD_helper_functions.jl:48-79).

    The mechanism must have a floating base joint first (``parse_urdf(...,
    floating=True)``).  ``u`` spans all nv degrees of freedom — like the
    reference, the base is directly actuated (6 wrench components) alongside
    the joint torques.

    ``analytic_derivatives`` (default on) routes forward dynamics through
    the Carpentier-Mansard custom JVP
    (:func:`ilqr_tpu_torch.models.rbd.dynamics.
    make_forward_dynamics_analytic_jvp`): identical values, and forward-mode
    AD of the dynamics differentiates only the RNEA recursion at fixed
    acceleration instead of CRBA + Cholesky.  Set False for the plain-AD
    path.
    """

    return _components_last(_rk4_last(_continuous_dynamics_last(
        mech, reference_kinematics, analytic_derivatives), dt))


def _stage_jacobians_last(mech: Mechanism, reference_kinematics: bool):
    nv = mech.nv
    nj = nv - 6

    def stage(x, u):
        dtype, device = x.dtype, x.device
        p = x[..., 0:3]
        r = x[..., 3:6]
        theta = x[..., 6:6 + nj]
        vel = x[..., 6 + nj:]
        omega = vel[..., 0:3]
        v_lin = vel[..., 3:6]

        quat = q_from_p(p)
        Jqp = q_from_p_jac(p)           # [..., 4, 3] chart jacobian

        q_mech = torch.cat([quat, r, theta], dim=-1)
        vdot, dvd_dq, dvd_dv, Minv = forward_dynamics_derivatives(
            mech, q_mech, vel, u)

        p_dot = pdot_from_w(p, omega)
        Jpp, Jpw = pdot_from_w_jac(p, omega)

        Z33 = torch.zeros((3, 3), dtype=dtype, device=device)
        if reference_kinematics:
            r_dot = v_lin                       # the reference's ṙ = v quirk
            Jrp = Z33
            Jrv = torch.eye(3, dtype=dtype, device=device)
        else:
            R = quat_to_rotmat(quat)
            r_dot = mv(R, v_lin)
            # ∂(R(q(p)) v)/∂p via the chart chain rule: column k of the
            # [3, 4] factor is ∂R/∂quat_k v.
            dR_v = mv(quat_to_rotmat_jac(quat), v_lin[..., None, :])
            Jrp = dR_v.transpose(-1, -2) @ Jqp
            Jrv = R
        theta_dot = vel[..., 6:]

        f = torch.cat([p_dot, r_dot, theta_dot, vdot], dim=-1)

        # Assemble Fx row blocks: [ṗ; ṙ; θ̇; v̇] × [p, r, θ, ω, v, θ̇].
        Znj = torch.zeros((3, nj), dtype=dtype, device=device)
        row_t = torch.cat(
            [torch.zeros((nj, nv + 6), dtype=dtype, device=device),
             torch.eye(nj, dtype=dtype, device=device)], dim=1)
        # v̇ rows: ∂v̇/∂p = ∂v̇/∂quat · ∂quat/∂p; r, θ map straight through.
        row_v = torch.cat(
            [dvd_dq[..., :, :4] @ Jqp, dvd_dq[..., :, 4:7],
             dvd_dq[..., :, 7:7 + nj], dvd_dv], dim=-1)
        Fx = block([[Jpp, Z33, Znj, Jpw, Z33, Znj],
                    [Jrp, Z33, Znj, Z33, Jrv, Znj],
                    [row_t],
                    [row_v]])

        Fu = block([[torch.zeros((nv, nv), dtype=dtype, device=device)],
                    [Minv]])
        return f, Fx, Fu

    return stage


def make_rbd_stage_jacobians(mech: Mechanism,
                             reference_kinematics: bool = False):
    """``(f_c(x, u), ∂f_c/∂x [n, n], ∂f_c/∂u [n, m])`` of the continuous
    dynamics in ONE explicit sweep — no tangent replay at all.

    The velocity rows come from
    :func:`ilqr_tpu_torch.models.rbd.dynamics.forward_dynamics_derivatives`
    (explicit Carpentier-Mansard ∂RNEA/∂q, ∂RNEA/∂v + one primal Cholesky
    shared by the forward-dynamics solve, both derivative solves, and
    ``∂v̇/∂u = M⁻¹``); the chart rows (MRP kinematics ``ṗ(p, ω)``, base
    position ``ṙ``, and the MRP→quaternion jacobian ``∂quat/∂p``) are the
    closed forms of ``rotations.*_jac``.
    """

    return _components_last(
        _stage_jacobians_last(mech, reference_kinematics),
        n_out_matrix=(1, 2))


def make_rbd_dynamics_jacobians(mech: Mechanism, dt: float = 0.01,
                                reference_kinematics: bool = False,
                                explicit_derivatives: bool = True):
    """Analytic ``(A, B) = (∂x'/∂x, ∂x'/∂u)`` of the RK4 step — the custom
    ``Problem.dynamics_jacobians`` override for the RBD model.

    Per-stage Jacobians composed with the RK4 chain rule:

    * per stage, ``(f_c, Fx [n, n], Fu [n, m])`` from
      :func:`make_rbd_stage_jacobians` — the explicit Carpentier-Mansard
      ∂RNEA/∂q, ∂RNEA/∂v matrix-recursion sweep (one pass producing every
      partial, sharing the primal Cholesky factor with the forward-
      dynamics solve and with ``Fu = [0; M⁻¹]``);
    * chain rule: ``K1x = dt·F1x``, ``K2x = dt·F2x (I + K1x/2)``,
      ``K3x = dt·F3x (I + K2x/2)``, ``K4x = dt·F4x (I + K3x)``,
      ``A = I + (K1x + 2K2x + 2K3x + K4x)/6`` (and the matching ``u``
      recursion with the stage ``Fu`` forcing terms) — [n, n] products
      batched over scenario lanes.

    Algebraically identical to forward-mode AD of :func:`make_rbd_dynamics`
    (chain rule), equal to it numerically up to rounding.

    ``explicit_derivatives``: ``True`` (default) is the explicit sweep
    above.  ``False`` is the replay, the JAX package's default: one ``jvp``
    of the continuous dynamics per state basis vector through the analytic
    forward-dynamics JVP (the primal — CRBA, RNEA, Cholesky — is shared by
    all n tangents under ``vmap``), with ``Fu = [0; M⁻¹]`` from one more
    solve against a second factorization.  The default is the faster of the
    two on an H100 (both times are in PERF.md): eager PyTorch batches the
    sweep's small matrix products over the lanes.  (The JAX package's
    default is the replay for a reason of its compiler: XLA fuses the
    replayed tangent graph into a few wide programs on a TPU.)
    """

    nv = mech.nv
    nj = nv - 6
    n = 2 * nv

    if explicit_derivatives:
        stage_all = _stage_jacobians_last(mech, reference_kinematics)
    else:
        continuous_dynamics = _continuous_dynamics_last(
            mech, reference_kinematics, analytic_derivatives=True)

        def stage_val_and_fx(x, u):
            """``(f_c(x, u), ∂f_c/∂x [..., n, n])`` in one n-tangent sweep
            (the primal is shared across tangents by vmap, computed
            once)."""

            def jvp_one(t):
                return torch.func.jvp(lambda xx: continuous_dynamics(xx, u),
                                      (x,), (t,))

            eye = torch.eye(n, dtype=x.dtype, device=x.device)
            basis = eye.reshape((n,) + (1,) * (x.ndim - 1) + (n,)).expand(
                (n,) + x.shape)
            val, rows = torch.func.vmap(jvp_one, out_dims=(None, 0))(basis)
            # rows[i] = ∂f/∂x · e_i → column i of Fx.
            return val, rows.movedim(0, -1)

        def stage_fu(x):
            """``∂f_c/∂u = [0; M(q)^{-1}] [..., n, m]`` (chart rows never see
            u)."""

            q_mech = torch.cat([q_from_p(x[..., 0:3]), x[..., 3:6 + nj]],
                               dim=-1)
            L = cholesky_small(crba_mass_matrix(mech, q_mech))
            eye = torch.eye(nv, dtype=x.dtype, device=x.device)
            Minv = _chol_solve(L, eye.expand(L.shape))
            return block([[torch.zeros((nv, nv), dtype=x.dtype,
                                       device=x.device)], [Minv]])

        def stage_all(x, u):
            f, Fx = stage_val_and_fx(x, u)
            return f, Fx, stage_fu(x)

    def dynamics_jacobians(x, u):
        eye = torch.eye(n, dtype=x.dtype, device=x.device)

        f1, F1, G1 = stage_all(x, u)
        x2 = x + dt * f1 / 2.0
        f2, F2, G2 = stage_all(x2, u)
        x3 = x + dt * f2 / 2.0
        f3, F3, G3 = stage_all(x3, u)
        x4 = x + dt * f3
        _f4, F4, G4 = stage_all(x4, u)

        K1x = dt * F1
        K2x = dt * (F2 @ (eye + K1x / 2.0))
        K3x = dt * (F3 @ (eye + K2x / 2.0))
        K4x = dt * (F4 @ (eye + K3x))
        A = eye + (K1x + 2.0 * K2x + 2.0 * K3x + K4x) / 6.0

        K1u = dt * G1
        K2u = dt * (F2 @ (K1u / 2.0) + G2)
        K3u = dt * (F3 @ (K2u / 2.0) + G3)
        K4u = dt * (F4 @ K3u + G4)
        B = (K1u + 2.0 * K2u + 2.0 * K3u + K4u) / 6.0
        return A, B

    return _components_last(dynamics_jacobians, n_out_matrix=(0, 1))


def make_rbd_arm_problem(target_pose: Optional[Sequence[float]] = None,
                         urdf_path: str = TWO_DOF_ARM_URDF,
                         dt: float = 0.01,
                         terminal_weight: float = 1e5,
                         reference_kinematics: bool = False,
                         analytic_derivatives: bool = True,
                         analytic_jacobians: bool = True,
                         explicit_derivatives: bool = True) -> Problem:
    """The reference's floating-base 2-DoF arm swing-up
    (animate_RBD_2_link.jl:8-10 + RBD_helper_functions.jl:85-116):
    zero gravity, pose target [MRP(3), position(3), joints(2)], diagonal
    pose/torque weights, heavy terminal weight.

    ``urdf_path=SIX_DOF_ARM_URDF`` with a 12-component ``target_pose`` gives
    the 6-DoF arm (n=24, m=12); ``urdf_path=DUAL_6DOF_ARM_URDF`` with an
    18-component one the free-flying dual arm (n=36, m=18);
    ``urdf_path=FIVE_6DOF_ARM_URDF`` with a 36-component one the
    free-flying five-arm (n=72, m=36).

    With ``analytic_jacobians=True`` (default) the problem carries
    :func:`make_rbd_dynamics_jacobians` as ``dynamics_jacobians`` (the
    explicit sweep, or the replay with ``explicit_derivatives=False``).
    With ``analytic_jacobians=False`` the engine takes forward-mode AD of
    the dynamics itself: through the custom forward-dynamics JVP
    (``analytic_derivatives=True``) or through CRBA + Cholesky (``False``).
    The costs are differentiated by AD, as in the JAX model.
    """

    mech = parse_urdf(urdf_path, floating=True, gravity=(0.0, 0.0, 0.0))
    nj = mech.nv - 6
    npose = 6 + nj
    if target_pose is None:
        # The example's target (animate_RBD_2_link.jl:10).
        target_pose = [0.0, 0.0, 0.0, 5.0, 1.0, 2.0, 1.0, 0.3]
    target_pose = [float(t) for t in target_pose]
    assert len(target_pose) == npose

    if analytic_jacobians:
        jacobians = make_rbd_dynamics_jacobians(
            mech, dt=dt, reference_kinematics=reference_kinematics,
            explicit_derivatives=explicit_derivatives)
    else:
        jacobians = None
    dynamics = make_rbd_dynamics(mech, dt=dt,
                                 reference_kinematics=reference_kinematics,
                                 analytic_derivatives=analytic_derivatives)

    # Diagonal weights from RBD_helper_functions.jl:88-116.
    weights64 = dict(
        target=target_pose,
        q=[100.0] * 3 + [1.0] * 3 + [10.0] * nj,
        r=[1.0] * 3 + [100.0] * 3 + [10.0] * nj,
        qf=[100.0] * 3 + [1000.0] * 3 + [10.0] * nj,
        ten=10.0,
        terminal=float(terminal_weight),
    )
    cache = {}

    def consts(x):
        """The cost's constants on ``x``'s device and dtype, vectors shaped
        ``[k, 1, ...]`` to broadcast against ``x [k, ...]``.  Made once per
        (device, dtype, rank).  The two scalar factors are 0-d TENSORS of
        the working type: a Python float times a per-scenario 0-d float32
        tensor comes out float64 under ``torch.func.vmap``."""

        key = (x.device, x.dtype, x.ndim)
        if key not in cache:
            def vec(v):
                t = torch.tensor(v, dtype=x.dtype, device=x.device)
                return t.reshape(t.shape + (1,) * (x.ndim - 1))
            cache[key] = {k: vec(v) for k, v in weights64.items()}
        return cache[key]

    def immediate_cost(x, u):
        c = consts(x)
        dx = c["target"] - x[:npose]
        return (c["ten"] * torch.sum(c["q"] * dx * dx, dim=0)
                + torch.sum(c["r"] * u * u, dim=0))

    def final_cost(x):
        c = consts(x)
        dx = c["target"] - x[:npose]
        return c["terminal"] * torch.sum(c["qf"] * dx * dx, dim=0)

    return Problem(
        dynamics=dynamics,
        cost=immediate_cost,
        final_cost=final_cost,
        state_dim=2 * mech.nv,
        control_dim=mech.nv,
        name="rbd_2dof_arm",
        dynamics_jacobians=jacobians,
        batch_trailing=True,
    )
