"""Differentiable rigid-body dynamics in PyTorch.

Counterpart of ``ilqr_tpu/models/rbd``: the replacement for the reference's
RigidBodyDynamics.jl + Attitude.jl model layer
(test/RBD_2_link_example/RBD_helper_functions.jl) — a URDF parser,
Featherstone spatial algebra, CRBA mass matrix, RNEA bias forces, their
explicit derivatives, floating-base support with an MRP attitude chart, and
an RK4 discrete-dynamics factory.  Every function batches over leading dims
and is safe under ``torch.func``.
"""

from ilqr_tpu_torch.models.rbd.urdf import Mechanism, parse_urdf
from ilqr_tpu_torch.models.rbd.dynamics import (
    crba_mass_matrix,
    rnea_bias,
    forward_dynamics,
)
from ilqr_tpu_torch.models.rbd.model import (
    DUAL_6DOF_ARM_URDF,
    FIVE_6DOF_ARM_URDF,
    SIX_DOF_ARM_URDF,
    TWO_DOF_ARM_URDF,
    make_rbd_dynamics,
    make_rbd_arm_problem,
    rbd_to_mrp_state,
    mrp_to_rbd_state,
)

__all__ = [
    "Mechanism",
    "parse_urdf",
    "crba_mass_matrix",
    "rnea_bias",
    "forward_dynamics",
    "make_rbd_dynamics",
    "make_rbd_arm_problem",
    "rbd_to_mrp_state",
    "mrp_to_rbd_state",
    "DUAL_6DOF_ARM_URDF",
    "FIVE_6DOF_ARM_URDF",
    "SIX_DOF_ARM_URDF",
    "TWO_DOF_ARM_URDF",
]
