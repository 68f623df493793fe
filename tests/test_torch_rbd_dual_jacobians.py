"""The free-flying dual arm's discrete dynamics and the Jacobians the port
hands the Riccati kernel at ``(36, 18)``, against the JAX package's problem
built from the same file, float64, CPU.

On a state near the nominal one (``tests/test_torch_rbd_dual.py``'s
``x0s``) with small random controls: the port's RK4 step ``f(x, u)`` and its
analytic ``(A, B)`` (the explicit sweep ``problem_linearize`` takes, as the
fused solve does) against one ``jax.jvp`` of the JAX problem's dynamics,
un-jitted on that state along a seeded random direction ``(dx, du)``: its
primal is ``f(x, u)`` and its tangent ``A dx + B du``, which a wrong entry
of either matrix moves.  (A whole JAX ``jacfwd``, or a jitted one, takes
minutes here, ``ROADMAP.md`` C9; the first ``jvp`` about twenty seconds, a
second state's ``f`` alone seven more, so the file holds one state;
``tests/test_torch_rbd_dual.py`` holds the forward dynamics and its
derivatives on another.)  Bar: rtol 1e-9 / atol 1e-10 on the tangent, that of
``tests/test_torch_al_6dof_jacobians.py`` (the two sides differentiate the
same RK4 step by different algebra), rtol 1e-10 / atol 1e-12 on ``f``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ilqr_tpu.models.rbd import model as jmodel
from ilqr_tpu_torch.derivatives import problem_linearize
from ilqr_tpu_torch.models.rbd import DUAL_6DOF_ARM_URDF
from tests.test_torch_rbd_dual import TARGET, port_problem, x0s
from tests.torch_parity import assert_close, to_torch

torch.set_num_threads(1)


def test_dynamics_and_jacobians_against_jax():
    xs = x0s(1, 37)
    rng = np.random.default_rng(0)
    us = 0.1 * rng.standard_normal((1, 18))
    dx, du = rng.standard_normal(36), rng.standard_normal(18)
    jprob = jmodel.make_rbd_arm_problem(target_pose=TARGET,
                                        urdf_path=DUAL_6DOF_ARM_URDF)
    fx, tangent = jax.jvp(jprob.dynamics,
                          (jnp.asarray(xs[0]), jnp.asarray(us[0])),
                          (jnp.asarray(dx), jnp.asarray(du)))
    problem = port_problem()
    tx, tu = to_torch(xs), to_torch(us)
    assert_close(problem.dynamics(tx[0], tu[0]), fx, 1e-10, 1e-12,
                 err_msg="f(x, u)")
    As, Bs = problem_linearize(problem, tx, tu)
    assert As.shape == (1, 36, 36) and Bs.shape == (1, 36, 18)
    assert_close(As[0] @ to_torch(dx) + Bs[0] @ to_torch(du), tangent, 1e-9,
                 1e-10, err_msg="A dx + B du")
