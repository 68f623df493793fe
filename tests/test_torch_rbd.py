"""The port's rigid-body layer against the JAX package's, float64, CPU.

Rotations, spatial algebra, kinematics, and the tree algorithms (CRBA, RNEA,
forward dynamics, the explicit Carpentier-Mansard derivative sweep) on both
URDFs (the floating-base 2-DoF and 6-DoF arms), built in both packages from
ONE parsed URDF (``convert.mechanism_from_fields``).  The same numpy inputs,
made from a seed, go through both; the JAX functions run un-jitted on single
configurations (they compile slowly on the CPU), the port's run batched over
leading dims.

The port runs the MATRIX forms; the JAX package's public forward dynamics
routes the 2-DoF arm through its scalar-expanded copies, and takes its small
Jacobians by ``jacfwd`` where the port has closed forms.  Same formulas in
another order of operations: agreement is to rounding, rtol 1e-10 with an
atol of 1e-12 relative to the largest entry (structural zeros come out as
rounding noise on one side and exact zeros on the other).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_tpu.models.rbd import dynamics as jd
from ilqr_tpu.models.rbd import kinematics as jk
from ilqr_tpu.models.rbd import model as jmodel
from ilqr_tpu.models.rbd import rotations as jr
from ilqr_tpu.models.rbd import spatial as js
from ilqr_tpu.models.rbd.urdf import parse_urdf as jax_parse_urdf
from ilqr_tpu_torch.convert import mechanism_from_fields
from ilqr_tpu_torch.models.rbd import dynamics as td
from ilqr_tpu_torch.models.rbd import kinematics as tk
from ilqr_tpu_torch.models.rbd import model as tmodel
from ilqr_tpu_torch.models.rbd import rotations as tr
from ilqr_tpu_torch.models.rbd import spatial as ts
from ilqr_tpu_torch.models.rbd.urdf import parse_urdf
from tests.torch_parity import to_numpy, to_torch

RTOL = 1e-10
B = 3   # configurations per check

URDFS = {
    "2dof": (jmodel.TWO_DOF_ARM_URDF, tmodel.TWO_DOF_ARM_URDF),
    "6dof": (os.path.join(jmodel.ASSET_DIR, "6Dof_arm.urdf"),
             tmodel.SIX_DOF_ARM_URDF),
}
_mechs = {}


def mechanisms(name, floating=True):
    """``(JAX Mechanism, the port's built from its fields)``."""

    key = (name, floating)
    if key not in _mechs:
        jm = jax_parse_urdf(URDFS[name][0], floating=floating)
        _mechs[key] = (jm, mechanism_from_fields(jm))
    return _mechs[key]


def close(port, ref, rtol=RTOL):
    a, b = to_numpy(port), np.asarray(ref)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=rtol,
                               atol=1e-12 * max(1.0, np.abs(b).max()))


def per_row(fn, *arrays):
    """The un-jitted JAX function on each row, stacked."""

    outs = [fn(*(jnp.asarray(a[i]) for a in arrays))
            for i in range(arrays[0].shape[0])]
    if isinstance(outs[0], tuple):
        return tuple(np.stack([np.asarray(o[k]) for o in outs])
                     for k in range(len(outs[0])))
    return np.stack([np.asarray(o) for o in outs])


def state(mech, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, mech.nq))
    if mech.joints[0].joint_type == "floating":
        q[:, :4] /= np.linalg.norm(q[:, :4], axis=1, keepdims=True)
    return (q, rng.standard_normal((B, mech.nv)),
            rng.standard_normal((B, mech.nv)))


# --- urdf, convert --------------------------------------------------------

@pytest.mark.parametrize("floating", [True, False])
@pytest.mark.parametrize("name", sorted(URDFS))
def test_parse_urdf_and_mechanism_from_fields(name, floating):
    jm, from_fields = mechanisms(name, floating)
    own = parse_urdf(URDFS[name][1], floating=floating)
    assert own == from_fields            # the port's copy of the asset
    for field in ("nq", "nv", "q_slices", "v_slices", "parents", "gravity"):
        assert getattr(own, field) == getattr(jm, field), field
    assert [l.name for l in own.links] == [l.name for l in jm.links]
    assert own.n_bodies == jm.n_bodies


# --- rotations ------------------------------------------------------------

def test_rotations():
    rng = np.random.default_rng(0)
    v, w = rng.standard_normal((2, B, 3))
    q1, q2 = rng.standard_normal((2, B, 4))
    ang = rng.standard_normal(B)
    axis = v / np.linalg.norm(v, axis=1, keepdims=True)
    close(tr.skew(to_torch(v)), per_row(jr.skew, v))
    close(tr.quat_multiply(to_torch(q1), to_torch(q2)),
          per_row(jr.quat_multiply, q1, q2))
    close(tr.quat_to_rotmat(to_torch(q1)), per_row(jr.quat_to_rotmat, q1))
    close(tr.p_from_q(to_torch(q1)), per_row(jr.p_from_q, q1))
    close(tr.q_from_p(to_torch(v)), per_row(jr.q_from_p, v))
    close(tr.pdot_from_w(to_torch(v), to_torch(w)),
          per_row(jr.pdot_from_w, v, w))
    close(tr.rpy_to_rotmat(to_torch(v)), per_row(jr.rpy_to_rotmat, v))
    close(tr.axis_angle_to_rotmat(to_torch(axis), to_torch(ang)),
          per_row(jr.axis_angle_to_rotmat, axis, ang))
    # A single (unbatched) argument works too.
    close(tr.quat_to_rotmat(to_torch(q1[0])), jr.quat_to_rotmat(q1[0]))


def test_rotation_jacobians_match_jacfwd():
    """The port's closed forms against ``jacfwd`` of the JAX functions."""

    rng = np.random.default_rng(1)
    p, w = 0.5 * rng.standard_normal((2, B, 3))
    q = rng.standard_normal((B, 4))
    close(tr.q_from_p_jac(to_torch(p)), per_row(jax.jacfwd(jr.q_from_p), p))
    Jp, Jw = tr.pdot_from_w_jac(to_torch(p), to_torch(w))
    close(Jp, per_row(jax.jacfwd(jr.pdot_from_w, argnums=0), p, w))
    close(Jw, per_row(jax.jacfwd(jr.pdot_from_w, argnums=1), p, w))
    # jacfwd gives [3, 3, 4] (the coordinate last), the port [4, 3, 3].
    ref = per_row(jax.jacfwd(jr.quat_to_rotmat), q)
    close(tr.quat_to_rotmat_jac(to_torch(q)), np.moveaxis(ref, -1, -3))


# --- spatial --------------------------------------------------------------

def test_spatial():
    rng = np.random.default_rng(2)
    v6 = rng.standard_normal((B, 6))
    r = rng.standard_normal((B, 3))
    R = per_row(jr.quat_to_rotmat, rng.standard_normal((B, 4)))
    close(ts.crm(to_torch(v6)), per_row(js.crm, v6))
    close(ts.crf(to_torch(v6)), per_row(js.crf, v6))
    close(ts.xform(to_torch(R), to_torch(r)), per_row(js.xform, R, r))
    close(ts.xform_from_pose(to_torch(R), to_torch(r)),
          per_row(js.xform_from_pose, R, r))
    mass = np.abs(rng.standard_normal(B)) + 1.0
    A = rng.standard_normal((B, 3, 3))
    inertia = A @ np.swapaxes(A, -1, -2)
    close(ts.spatial_inertia(to_torch(mass)[:, None, None], to_torch(inertia),
                             to_torch(r)),
          per_row(js.spatial_inertia, mass, inertia, r))


# --- kinematics -----------------------------------------------------------

@pytest.mark.parametrize("name", sorted(URDFS))
def test_forward_kinematics(name):
    jm, tm = mechanisms(name)
    q, _, _ = state(jm, 3)
    poses = tk.forward_kinematics(tm, to_torch(q))
    ref = [jk.forward_kinematics(jm, jnp.asarray(q[i])) for i in range(B)]
    assert len(poses) == jm.n_bodies
    for body, (R, p) in enumerate(poses):
        close(R, np.stack([np.asarray(ref[i][body][0]) for i in range(B)]))
        close(p, np.stack([np.asarray(ref[i][body][1]) for i in range(B)]))
    last = jm.links[-1].name
    point = [0.1, -0.2, 0.3]
    assert tk.body_index(tm, last) == jk.body_index(jm, last)
    close(tk.body_point_in_world(tm, to_torch(q), last, point),
          per_row(lambda qq: jk.body_point_in_world(jm, qq, last, point), q))


def test_kinematics_prismatic_and_fixed_joints():
    """Joint types the two arms do not have."""

    urdf = """<robot name="slider">
      <link name="base"><inertial><mass value="1"/><inertia ixx="1" iyy="1"
        izz="1" ixy="0" ixz="0" iyz="0"/></inertial></link>
      <link name="cart"><inertial><origin xyz="0.1 0 0.2" rpy="0.3 0 0"/>
        <mass value="2"/><inertia ixx="0.5" iyy="0.4" izz="0.3" ixy="0.01"
        ixz="0" iyz="0"/></inertial></link>
      <link name="tip"><inertial><mass value="0.5"/><inertia ixx="0.1"
        iyy="0.1" izz="0.1" ixy="0" ixz="0" iyz="0"/></inertial></link>
      <joint name="slide" type="prismatic"><parent link="base"/>
        <child link="cart"/><origin xyz="0 0.1 0" rpy="0.2 -0.1 0.4"/>
        <axis xyz="0 0 1"/></joint>
      <joint name="weld" type="fixed"><parent link="cart"/>
        <child link="tip"/><origin xyz="0.3 0 0" rpy="0 0.5 0"/></joint>
    </robot>"""
    jm = jax_parse_urdf(urdf, floating=False)
    tm = mechanism_from_fields(jm)
    assert tm == parse_urdf(urdf, floating=False)
    q, v, a = state(jm, 4)
    tq, tv, ta = map(to_torch, (q, v, a))
    close(td.crba_mass_matrix(tm, tq),
          per_row(lambda q_: jd.crba_mass_matrix(jm, q_), q))
    close(td.rnea_inverse_dynamics(tm, tq, tv, ta),
          per_row(lambda *z: jd.rnea_inverse_dynamics(jm, *z), q, v, a))
    out = td.rnea_derivatives(tm, tq, tv, ta)
    ref = per_row(lambda *z: jd.rnea_derivatives(jm, *z), q, v, a)
    for o, r in zip(out, ref):
        close(o, r)


# --- the tree algorithms --------------------------------------------------

@pytest.mark.parametrize("name", sorted(URDFS))
def test_crba_rnea_forward_dynamics(name):
    jm, tm = mechanisms(name)
    q, v, a = state(jm, 5)
    tq, tv, ta = map(to_torch, (q, v, a))
    M = td.crba_mass_matrix(tm, tq)
    close(M, per_row(lambda q_: jd.crba_mass_matrix(jm, q_), q))
    bias = td.rnea_bias(tm, tq, tv)
    close(bias, per_row(lambda *z: jd.rnea_bias(jm, *z), q, v))
    tau = td.rnea_inverse_dynamics(tm, tq, tv, ta)
    close(tau, per_row(lambda *z: jd.rnea_inverse_dynamics(jm, *z), q, v, a))
    # The identity the analytic derivative rule relies on, any raw q.
    close(tau, to_numpy(ts.mv(M, ta) + bias))
    # The JAX forward dynamics takes its size-gated (scalar) forms here.
    close(td.forward_dynamics(tm, tq, tv, ta),
          per_row(lambda *z: jd.forward_dynamics(jm, *z), q, v, a))
    # Unbatched call.
    close(td.forward_dynamics(tm, tq[0], tv[0], ta[0]),
          jd.forward_dynamics(jm, *(jnp.asarray(z[0]) for z in (q, v, a))))


@pytest.mark.parametrize("name", sorted(URDFS))
def test_rnea_and_forward_dynamics_derivatives(name):
    jm, tm = mechanisms(name)
    q, v, a = state(jm, 6)
    tq, tv, ta = map(to_torch, (q, v, a))
    out = td.rnea_derivatives(tm, tq, tv, ta)
    ref = per_row(lambda *z: jd.rnea_derivatives(jm, *z), q, v, a)
    assert out[1].shape == (B, jm.nv, jm.nq)
    for o, r in zip(out, ref):
        close(o, r)
    out = td.forward_dynamics_derivatives(tm, tq, tv, ta)
    ref = per_row(lambda *z: jd.forward_dynamics_derivatives(jm, *z), q, v, a)
    for o, r in zip(out, ref):
        close(o, r)


@pytest.mark.parametrize("name", sorted(URDFS))
def test_joint_dX_is_the_derivative_of_the_transform(name):
    """The closed form against forward-mode AD of the port's own joint
    transform, for every joint of the tree."""

    _, tm = mechanisms(name)
    q = to_torch(state(tm, 7)[0])
    for i, joint in enumerate(tm.joints):
        lo, hi = tm.q_slices[i]
        qj = q[:, lo:hi]
        dX = td._joint_dX(joint, qj)
        assert dX.shape == (B, 6, 6, hi - lo)
        for k in range(hi - lo):
            e = torch.zeros_like(qj)
            e[:, k] = 1.0
            _, ref = torch.func.jvp(
                lambda z: td._joint_X_and_S(joint, z)[0], (qj,), (e,))
            close(dX[..., k], ref)
