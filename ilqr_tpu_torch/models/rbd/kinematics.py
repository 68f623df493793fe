"""World-frame forward kinematics over the kinematic tree.

Counterpart of ``ilqr_tpu/models/rbd/kinematics.py``: the differentiable
equivalent of RigidBodyDynamics.jl's ``transform_to_root`` as the
reference's (dead) cost library uses it (src/cost_functions.jl:12-16: a
body-fixed point mapped to root frame for a workspace-distance cost), and
the pose source for 3-D visualization.

Configurations carry any number of LEADING batch dims (``q [..., nq]``).
The tree loops unroll in Python over the static tree.

What a URDF fixes (joint frames, axes, link inertias) is turned into
tensors once per ``(spec, dtype, device)``, computed in float64 on the host
and rounded to the working type, and cached: rebuilding a constant on every
call would be a host-to-device copy inside the rollout loops.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Tuple

import torch

from ilqr_tpu_torch.models.rbd.rotations import (
    quat_to_rotmat,
    rpy_to_rotmat,
    skew,
)
from ilqr_tpu_torch.models.rbd.urdf import JointSpec, Mechanism


class JointTensors(NamedTuple):
    """The fixed part of one joint: its frame in the parent link (URDF
    origin), its axis with ``K = skew(axis)`` and ``K @ K`` (Rodrigues), and
    ``R_origin @ axis`` (the prismatic direction in the parent frame)."""

    R_origin: torch.Tensor
    p_origin: torch.Tensor
    axis: torch.Tensor
    K: torch.Tensor
    KK: torch.Tensor
    R_axis: torch.Tensor


@functools.lru_cache(maxsize=None)
def joint_tensors(joint: JointSpec, dtype, device) -> JointTensors:
    f64 = functools.partial(torch.tensor, dtype=torch.float64)
    R_origin = rpy_to_rotmat(f64(joint.origin_rpy))
    axis = f64(joint.axis)
    K = skew(axis)
    parts = (R_origin, f64(joint.origin_xyz), axis, K, K @ K,
             R_origin @ axis)
    return JointTensors(*(p.to(device=device, dtype=dtype) for p in parts))


def joint_pose(joint: JointSpec, q):
    """Child-link pose in the parent-link frame at joint configuration
    ``q [..., dof_q]``: returns ``(R [..., 3, 3], p [..., 3])`` — the pose
    :func:`ilqr_tpu_torch.models.rbd.dynamics._joint_X_and_S` turns into a
    spatial transform."""

    c = joint_tensors(joint, q.dtype, q.device)
    if joint.joint_type in ("revolute", "continuous"):
        # Rodrigues: R_j = I + sin(q) K + (1 - cos(q)) K K.
        s = torch.sin(q[..., 0])[..., None, None]
        co = torch.cos(q[..., 0])[..., None, None]
        eye = torch.eye(3, dtype=q.dtype, device=q.device)
        return c.R_origin @ (eye + s * c.K + (1.0 - co) * c.KK), c.p_origin
    if joint.joint_type == "prismatic":
        return c.R_origin, c.p_origin + c.R_axis * q[..., :1]
    if joint.joint_type == "fixed":
        return c.R_origin, c.p_origin
    if joint.joint_type == "floating":
        # q = [quat (scalar-first, 4), pos (3)].
        return (c.R_origin @ quat_to_rotmat(q[..., :4]),
                c.p_origin + (c.R_origin @ q[..., 4:7, None])[..., 0])
    raise ValueError(f"unsupported joint type {joint.joint_type}")


def forward_kinematics(mech: Mechanism, q) -> List[Tuple[torch.Tensor,
                                                         torch.Tensor]]:
    """World pose ``(R_world_link [..., 3, 3], p_world_link [..., 3])`` of
    every body, in tree order (the ``transform_to_root`` of each link)."""

    poses: List[Tuple[torch.Tensor, torch.Tensor]] = []
    for i, joint in enumerate(mech.joints):
        lo, hi = mech.q_slices[i]
        R_j, p_j = joint_pose(joint, q[..., lo:hi])
        parent = mech.parents[i]
        if parent < 0:
            poses.append((R_j, p_j))
        else:
            R_p, p_p = poses[parent]
            poses.append((R_p @ R_j, p_p + (R_p @ p_j[..., None])[..., 0]))
    return poses


def body_index(mech: Mechanism, body_name: str) -> int:
    for i, link in enumerate(mech.links):
        if link.name == body_name:
            return i
    raise KeyError(f"no body named {body_name!r}; have "
                   f"{[l.name for l in mech.links]}")


def body_point_in_world(mech: Mechanism, q, body: int | str, point):
    """A body-fixed point mapped to the world (root) frame — the
    reference's ``transform(state, Point3D(body_frame, point), root_frame)``
    pattern (src/cost_functions.jl:12-16)."""

    idx = body_index(mech, body) if isinstance(body, str) else body
    R, p = forward_kinematics(mech, q)[idx]
    point = torch.as_tensor(point, dtype=q.dtype, device=q.device)
    return p + (R @ point[..., None])[..., 0]
