"""The free-flying five-arm (``models/rbd/assets/five_6Dof_arm.urdf``): five
6-DoF arms on one floating base in zero gravity, n=72, m=36, the model whose
Riccati step runs in ``csrc/riccati_cluster.cu`` on the card; float64, CPU.

* Both packages parse the file (the JAX package reads the port's asset by
  path) to the same mechanism: nv 36, the parents of the kinematic tree,
  every link's inertia and every joint's placement
  (``convert.mechanism_from_fields`` of the JAX mechanism equals the port's
  own parse).
* The forward dynamics and its derivatives (``∂q̈/∂q``, ``∂q̈/∂v``,
  ``∂q̈/∂τ``, the pieces of the model's explicit Jacobian sweep) against
  the JAX package's, un-jitted on one state (the JAX functions compile for
  minutes at this size; ``ROADMAP.md`` C9), rtol 1e-10 with an atol of
  1e-12 of the largest entry, as ``tests/test_torch_rbd.py`` holds the
  other arms.
* The fused solve against the per-scenario one:
  ``tests/test_torch_rbd_five_solve.py``.
"""

import functools

import jax.numpy as jnp
import numpy as np
import torch

from ilqr_tpu.models.rbd import dynamics as jd
from ilqr_tpu.models.rbd.urdf import parse_urdf as jax_parse_urdf
from ilqr_tpu_torch.convert import mechanism_from_fields
from ilqr_tpu_torch.models.rbd import (FIVE_6DOF_ARM_URDF,
                                       make_rbd_arm_problem)
from ilqr_tpu_torch.models.rbd import dynamics as td
from ilqr_tpu_torch.models.rbd.urdf import parse_urdf
from ilqr_tpu_torch.ops import cuda_riccati
from tests.torch_parity import to_numpy, to_torch

torch.set_num_threads(1)

# Pose target [MRP(3), position(3), joints(30)], as the 6-DoF arm's with
# every arm's joints at 0.3 (chip_smoke.py's rbd_five phase).
TARGET = [0.0, 0.0, 0.0, 1.0, 1.0, 1.0] + [0.3] * 30
# chip_smoke.rbd_config's Tassa flags, a 4-rung ladder.
FLAGS = dict(max_iter=3, tol=1e-5, tol_grad=1e-10, tol_grad_rel=1e-6,
             adaptive_reg=True, reg=1.0, reg_min=1e-3, reg_scale=10.0,
             reg_backtrack_trigger=1, max_backtracks=4,
             backward_backend="pallas")


def x0s(B, seed):
    """The nominal state (unit MRP-free attitude, base at z=1, at rest)
    with 0.02 of noise on every component, as the 6-DoF arm's
    (``scripts/bench_6dof.py``), extended to 72."""

    rng = np.random.default_rng(seed)
    nominal = np.array([0.0, 0.0, 1.0] + [0.0] * 69)
    return nominal + 0.02 * rng.standard_normal((B, 72))


@functools.lru_cache(maxsize=None)
def port_problem():
    return make_rbd_arm_problem(target_pose=TARGET,
                                urdf_path=FIVE_6DOF_ARM_URDF)


def close(port, ref, rtol=1e-10):
    a, b = to_numpy(port), np.asarray(ref)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=rtol,
                               atol=1e-12 * max(1.0, np.abs(b).max()))


def test_both_packages_parse_the_same_mechanism():
    jm = jax_parse_urdf(FIVE_6DOF_ARM_URDF, floating=True)
    own = parse_urdf(FIVE_6DOF_ARM_URDF, floating=True)
    assert own == mechanism_from_fields(jm)
    assert own.nv == jm.nv == 36 and own.nq == jm.nq == 37
    # The base, then the five arms breadth first: joint k of each arm hangs
    # from the base (k = 1) or from joint k-1 of its own arm.
    assert own.parents == jm.parents == (
        (-1, 0, 0, 0, 0, 0) + tuple(range(1, 31)))
    names = [j.name for j in own.joints]
    assert names[1:6] == ["joint_1", "joint_1_b", "joint_1_c", "joint_1_d",
                          "joint_1_e"]
    assert names[-5:] == ["tool_frame", "tool_frame_b", "tool_frame_c",
                          "tool_frame_d", "tool_frame_e"]
    # Arms B to E are arm A's copies: the same inertias, other mounts.
    links = {link.name: link for link in own.links}
    joints = {j.name: j for j in own.joints}
    for arm in ("b", "c", "d", "e"):
        for k in range(1, 7):
            a, b = links[f"link_{k}"], links[f"link_{k}_{arm}"]
            assert (a.mass, a.com, a.inertia) == (b.mass, b.com, b.inertia)
    assert [joints[f"joint_1{s}"].origin_xyz
            for s in ("", "_b", "_c", "_d", "_e")] == [
        (0.5, 0.5, 0.0), (0.5, -0.5, 0.0), (-0.5, 0.5, 0.0),
        (-0.5, -0.5, 0.0), (0.0, 0.0, 0.5)]
    problem = port_problem()
    assert (problem.state_dim, problem.control_dim) == (72, 36)
    assert cuda_riccati.route(72, 36) == ("riccati_cluster", 72, 36)
    # Under al_solve the step index joins the state.
    assert cuda_riccati.route(73, 36) == ("riccati_cluster", 73, 36)


def test_forward_dynamics_and_derivatives_against_jax():
    jm = jax_parse_urdf(FIVE_6DOF_ARM_URDF, floating=True,
                        gravity=(0.0, 0.0, 0.0))
    tm = mechanism_from_fields(jm)
    rng = np.random.default_rng(36)
    q = rng.standard_normal(jm.nq)
    q[:4] /= np.linalg.norm(q[:4])
    v, tau = rng.standard_normal(jm.nv), rng.standard_normal(jm.nv)
    jq, jv, jt = (jnp.asarray(z) for z in (q, v, tau))
    tq, tv, tt = (to_torch(z) for z in (q, v, tau))
    # (q̈, ∂q̈/∂q, ∂q̈/∂v, ∂q̈/∂τ); the JAX q̈ stands for its
    # forward_dynamics (one un-jitted JAX call fewer).
    out = td.forward_dynamics_derivatives(tm, tq, tv, tt)
    ref = jd.forward_dynamics_derivatives(jm, jq, jv, jt)
    assert len(out) == len(ref) == 4
    for o, r in zip(out, ref):
        close(o, r)
    close(td.forward_dynamics(tm, tq, tv, tt), ref[0])
