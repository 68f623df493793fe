"""URDF parsing into a static kinematic-tree description.

Replacement for RigidBodyDynamics.jl's ``parse_urdf`` as used by the
reference (RBD_helper_functions.jl:7-8, with ``floating = true`` turning
the root link into a quaternion floating base).  Parsing happens once at
build time in plain Python (xml.etree); the result is a static, hashable
structure of Python floats/ints (a copy of ``ilqr_tpu/models/rbd/urdf.py``,
same fields) from which the rigid-body layer builds its constant tensors —
no device work here.

Supported: ``revolute``/``continuous``, ``prismatic``, ``fixed`` joints,
link ``<inertial>`` blocks (mass, 3x3 inertia about the COM frame, COM
origin), joint origins (xyz + rpy), joint axes, and effort/velocity limits
(parsed and stored; like the reference, the solver itself is unconstrained
— limits are available to user costs).  Visual/collision geometry is
ignored (not needed for dynamics).
"""

from __future__ import annotations

import dataclasses
import xml.etree.ElementTree as ET
from typing import Optional, Tuple


def _floats(s: Optional[str], default) -> Tuple[float, ...]:
    if s is None:
        return tuple(default)
    return tuple(float(x) for x in s.split())


@dataclasses.dataclass(frozen=True)
class LinkSpec:
    name: str
    mass: float
    # Inertia about the COM, in the inertial frame (rotated into the link
    # frame at parse time if the inertial origin has rpy).
    inertia: Tuple[Tuple[float, float, float], ...]  # 3x3
    com: Tuple[float, float, float]  # COM position in the link frame


@dataclasses.dataclass(frozen=True)
class JointSpec:
    name: str
    joint_type: str  # "revolute" | "prismatic" | "fixed" | "floating"
    parent: str
    child: str
    axis: Tuple[float, float, float]
    origin_xyz: Tuple[float, float, float]
    origin_rpy: Tuple[float, float, float]
    effort_limit: Optional[float] = None
    velocity_limit: Optional[float] = None
    lower: Optional[float] = None
    upper: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class Mechanism:
    """A topologically-ordered kinematic tree.

    ``joints[i]`` connects ``links[i]`` (the child body) to its parent,
    whose index is ``parents[i]`` (-1 = world).  ``nq``/``nv`` are total
    configuration / velocity dimensions; each joint's slices are
    ``q_slices[i]`` / ``v_slices[i]``.
    """

    name: str
    links: Tuple[LinkSpec, ...]
    joints: Tuple[JointSpec, ...]
    parents: Tuple[int, ...]
    gravity: Tuple[float, float, float] = (0.0, 0.0, -9.81)

    def __post_init__(self):
        q_slices, v_slices = [], []
        nq = nv = 0
        for j in self.joints:
            dq, dv = joint_dims(j.joint_type)
            q_slices.append((nq, nq + dq))
            v_slices.append((nv, nv + dv))
            nq += dq
            nv += dv
        object.__setattr__(self, "q_slices", tuple(q_slices))
        object.__setattr__(self, "v_slices", tuple(v_slices))
        object.__setattr__(self, "nq", nq)
        object.__setattr__(self, "nv", nv)

    @property
    def n_bodies(self) -> int:
        return len(self.links)


def joint_dims(joint_type: str) -> Tuple[int, int]:
    """(config dim, velocity dim) per joint type.  The floating joint uses a
    quaternion (4) + position (3) configuration and a 6-D spatial velocity,
    matching RigidBodyDynamics.jl's QuaternionFloating."""

    return {
        "revolute": (1, 1),
        "continuous": (1, 1),
        "prismatic": (1, 1),
        "fixed": (0, 0),
        "floating": (7, 6),
    }[joint_type]


def _parse_link(el) -> LinkSpec:
    inertial = el.find("inertial")
    if inertial is None:
        return LinkSpec(el.get("name"), 0.0,
                        tuple((0.0,) * 3 for _ in range(3)), (0.0, 0.0, 0.0))
    mass = float(inertial.find("mass").get("value"))
    io = inertial.find("origin")
    xyz = _floats(None if io is None else io.get("xyz"), (0.0, 0.0, 0.0))
    rpy = _floats(None if io is None else io.get("rpy"), (0.0, 0.0, 0.0))
    ie = inertial.find("inertia")
    ixx = float(ie.get("ixx", 0)); iyy = float(ie.get("iyy", 0))
    izz = float(ie.get("izz", 0)); ixy = float(ie.get("ixy", 0))
    ixz = float(ie.get("ixz", 0)); iyz = float(ie.get("iyz", 0))
    I = [[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]]
    if any(abs(v) > 0 for v in rpy):
        # Rotate the inertia tensor from the inertial frame into the link
        # frame: I_link = R I R^T.
        import math

        def rot(rpy):
            r, p, y = rpy
            cr, sr = math.cos(r), math.sin(r)
            cp, sp = math.cos(p), math.sin(p)
            cy, sy = math.cos(y), math.sin(y)
            Rx = [[1, 0, 0], [0, cr, -sr], [0, sr, cr]]
            Ry = [[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]]
            Rz = [[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]]
            def mm(A, B):
                return [[sum(A[i][k] * B[k][j] for k in range(3))
                         for j in range(3)] for i in range(3)]
            return mm(Rz, mm(Ry, Rx))

        R = rot(rpy)
        RT = [[R[j][i] for j in range(3)] for i in range(3)]
        def mm(A, B):
            return [[sum(A[i][k] * B[k][j] for k in range(3))
                     for j in range(3)] for i in range(3)]
        I = mm(R, mm(I, RT))
    return LinkSpec(el.get("name"), mass, tuple(tuple(r) for r in I), xyz)


def _parse_joint(el) -> JointSpec:
    origin = el.find("origin")
    axis = el.find("axis")
    limit = el.find("limit")
    return JointSpec(
        name=el.get("name"),
        joint_type=el.get("type"),
        parent=el.find("parent").get("link"),
        child=el.find("child").get("link"),
        axis=_floats(None if axis is None else axis.get("xyz"), (1.0, 0.0, 0.0)),
        origin_xyz=_floats(None if origin is None else origin.get("xyz"),
                           (0.0, 0.0, 0.0)),
        origin_rpy=_floats(None if origin is None else origin.get("rpy"),
                           (0.0, 0.0, 0.0)),
        effort_limit=None if limit is None or limit.get("effort") is None
        else float(limit.get("effort")),
        velocity_limit=None if limit is None or limit.get("velocity") is None
        else float(limit.get("velocity")),
        lower=None if limit is None or limit.get("lower") is None
        else float(limit.get("lower")),
        upper=None if limit is None or limit.get("upper") is None
        else float(limit.get("upper")),
    )


def parse_urdf(path_or_string: str, floating: bool = False,
               gravity=(0.0, 0.0, -9.81)) -> Mechanism:
    """Parse a URDF file (or XML string) into a :class:`Mechanism`.

    ``floating=True`` attaches the root link to the world through a
    quaternion floating joint (the reference's ``parse_urdf(urdf,
    floating=true)``, RBD_helper_functions.jl:8); otherwise the root link is
    welded to the world (fixed joint).
    """

    if path_or_string.lstrip().startswith("<"):
        root = ET.fromstring(path_or_string)
    else:
        root = ET.parse(path_or_string).getroot()

    link_els = {el.get("name"): el for el in root.findall("link")}
    joint_els = [_parse_joint(el) for el in root.findall("joint")]

    children = {j.child for j in joint_els}
    roots = [name for name in link_els if name not in children]
    assert len(roots) == 1, f"URDF must have exactly one root link, got {roots}"
    root_name = roots[0]

    base_joint = JointSpec(
        name="base",
        joint_type="floating" if floating else "fixed",
        parent="__world__",
        child=root_name,
        axis=(0.0, 0.0, 1.0),
        origin_xyz=(0.0, 0.0, 0.0),
        origin_rpy=(0.0, 0.0, 0.0),
    )

    # Topological order: BFS from the root.
    by_parent = {}
    for j in joint_els:
        by_parent.setdefault(j.parent, []).append(j)
    ordered_joints = [base_joint]
    ordered_links = [_parse_link(link_els[root_name])]
    parents = [-1]
    index_of = {root_name: 0}
    frontier = [root_name]
    while frontier:
        name = frontier.pop(0)
        for j in sorted(by_parent.get(name, []), key=lambda j: j.name):
            idx = len(ordered_links)
            ordered_joints.append(j)
            ordered_links.append(_parse_link(link_els[j.child]))
            parents.append(index_of[name])
            index_of[j.child] = idx
            frontier.append(j.child)

    assert len(ordered_links) == len(link_els), "disconnected links in URDF"
    return Mechanism(
        name=root.get("name", "robot"),
        links=tuple(ordered_links),
        joints=tuple(ordered_joints),
        parents=tuple(parents),
        gravity=tuple(float(g) for g in gravity),
    )
