"""The free-flying dual arm (``models/rbd/assets/dual_6Dof_arm.urdf``): two
6-DoF arms on one floating base in zero gravity, n=36, m=18, the model whose
Riccati step runs in ``csrc/riccati_xl.cu`` on the card; float64, CPU.

* Both packages parse the file (the JAX package reads the port's asset by
  path) to the same mechanism: nv 18, the parents of the kinematic tree,
  every link's inertia and every joint's placement
  (``convert.mechanism_from_fields`` of the JAX mechanism equals the port's
  own parse).
* The forward dynamics and its derivatives (``∂q̈/∂q``, ``∂q̈/∂v``,
  ``∂q̈/∂τ``, the pieces of the model's explicit Jacobian sweep) against
  the JAX package's, un-jitted on one state (the JAX functions compile for
  minutes at this size; ``ROADMAP.md`` C9), rtol 1e-10 with an atol of
  1e-12 of the largest entry, as ``tests/test_torch_rbd.py`` holds the
  other arms.  The discrete dynamics and its Jacobians are held in
  ``tests/test_torch_rbd_dual_jacobians.py``.
* One fused solve (``make_batch_solver(engine="fused")``, the path that
  reaches the kernel's batch-last entry at ``(36, 18)``; here its plain
  version) at B=2, T=4, equal to the port's per-scenario ``solve`` of each
  lane: status and iterations identical, every float field within rtol
  1e-10 / atol 1e-12 (two float64 programs whose sums run in another
  order), as ``tests/test_torch_al_6dof.py`` holds its two backends.
"""

import functools

import jax.numpy as jnp
import numpy as np
import torch

from ilqr_tpu.models.rbd import dynamics as jd
from ilqr_tpu.models.rbd.urdf import parse_urdf as jax_parse_urdf
from ilqr_tpu_torch.config import ILQRConfig
from ilqr_tpu_torch.convert import mechanism_from_fields
from ilqr_tpu_torch.models.rbd import (DUAL_6DOF_ARM_URDF,
                                       make_rbd_arm_problem)
from ilqr_tpu_torch.models.rbd import dynamics as td
from ilqr_tpu_torch.models.rbd.urdf import parse_urdf
from ilqr_tpu_torch.ops import cuda_riccati
from ilqr_tpu_torch.parallel.batching import make_batch_solver
from ilqr_tpu_torch.problem import rollout
from ilqr_tpu_torch.solver import solve
from tests.torch_parity import to_numpy, to_torch

torch.set_num_threads(1)

# Pose target [MRP(3), position(3), joints(12)], as the 6-DoF arm's with
# both arms' joints at 0.3 (chip_smoke.py's rbd_dual phase).
TARGET = [0.0, 0.0, 0.0, 1.0, 1.0, 1.0] + [0.3] * 12
# chip_smoke.rbd_config's Tassa flags, a 4-rung ladder.
FLAGS = dict(max_iter=3, tol=1e-5, tol_grad=1e-10, tol_grad_rel=1e-6,
             adaptive_reg=True, reg=1.0, reg_min=1e-3, reg_scale=10.0,
             reg_backtrack_trigger=1, max_backtracks=4,
             backward_backend="pallas")


def x0s(B, seed):
    """The nominal state (unit MRP-free attitude, base at z=1, at rest)
    with 0.02 of noise on every component, as the 6-DoF arm's
    (``scripts/bench_6dof.py``), extended to 36."""

    rng = np.random.default_rng(seed)
    nominal = np.array([0.0, 0.0, 1.0] + [0.0] * 33)
    return nominal + 0.02 * rng.standard_normal((B, 36))


@functools.lru_cache(maxsize=None)
def port_problem():
    return make_rbd_arm_problem(target_pose=TARGET,
                                urdf_path=DUAL_6DOF_ARM_URDF)


def close(port, ref, rtol=1e-10):
    a, b = to_numpy(port), np.asarray(ref)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=rtol,
                               atol=1e-12 * max(1.0, np.abs(b).max()))


def test_both_packages_parse_the_same_mechanism():
    jm = jax_parse_urdf(DUAL_6DOF_ARM_URDF, floating=True)
    own = parse_urdf(DUAL_6DOF_ARM_URDF, floating=True)
    assert own == mechanism_from_fields(jm)
    assert own.nv == jm.nv == 18 and own.nq == jm.nq == 19
    # The base, then the two arms breadth first: joint k of arm A and of
    # arm B hang from the base (k = 1) or from joint k-1 of their own arm.
    assert own.parents == jm.parents == (
        (-1, 0, 0) + tuple(range(1, 13)))
    names = [j.name for j in own.joints]
    assert names[1:3] == ["joint_1", "joint_1_b"]
    assert names[-2:] == ["tool_frame", "tool_frame_b"]
    # Arm B is arm A's copy: the same inertias, its first joint mirrored.
    links = {link.name: link for link in own.links}
    for k in range(1, 7):
        a, b = links[f"link_{k}"], links[f"link_{k}_b"]
        assert (a.mass, a.com, a.inertia) == (b.mass, b.com, b.inertia)
    joints = {j.name: j for j in own.joints}
    assert joints["joint_1"].origin_xyz == (0.5, 0.5, 0.0)
    assert joints["joint_1_b"].origin_xyz == (0.5, -0.5, 0.0)
    problem = port_problem()
    assert (problem.state_dim, problem.control_dim) == (36, 18)
    assert cuda_riccati.route(36, 18) == ("riccati_xl", 36, 18)
    # Under al_solve the step index joins the state.
    assert cuda_riccati.route(37, 18) == ("riccati_xl", 37, 18)


def test_forward_dynamics_and_derivatives_against_jax():
    jm = jax_parse_urdf(DUAL_6DOF_ARM_URDF, floating=True,
                        gravity=(0.0, 0.0, 0.0))
    tm = mechanism_from_fields(jm)
    rng = np.random.default_rng(18)
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


def test_fused_solve_equals_the_per_scenario_solve():
    B, T = 2, 4
    problem = port_problem()
    x0 = to_torch(x0s(B, 36))
    us0 = torch.zeros((B, T, 18), dtype=torch.float64)
    config = ILQRConfig(**FLAGS)
    fused = make_batch_solver(problem, config, engine="fused",
                              device="cpu")(x0, us0)
    assert fused.us.shape == (B, T, 18) and fused.xs.shape == (B, T + 1, 36)
    assert int(fused.iterations.min()) >= 2
    for b in range(B):
        one = solve(problem, rollout(problem.dynamics, x0[b], us0[b]),
                    us0[b], config=config, device="cpu")
        for name, a, r in zip(one._fields, fused, one):
            if a.is_floating_point():
                torch.testing.assert_close(a[b], r, rtol=1e-10, atol=1e-12,
                                           msg=name)
            else:
                assert torch.equal(a[b], r), name
