"""The port's RBD dynamics Jacobians against the JAX package's, float64, CPU.

``make_rbd_arm_problem().dynamics_jacobians`` of the port — the explicit
Carpentier-Mansard sweep composed through the RK4 chain rule — against BOTH
JAX forms of the same hook, the explicit sweep and the default JVP replay,
which agree with each other to rounding: rtol 1e-9 on entries of size 1,
atol 1e-11 (the JAX side runs its scalar-expanded algebra and ``jacfwd`` of
the chart maps, the port matrix forms and closed forms).

The JAX functions run un-jitted on ONE state (15 to 20 s per form on a CPU;
jitted they compile for twice as long), which is why these two tests have a
file of their own.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_tpu.models.rbd import model as jmodel
from ilqr_tpu_torch.models.rbd import model as tmodel
from tests.test_torch_rbd_model import close, states
from tests.torch_parity import to_torch

torch.set_num_threads(1)


@pytest.mark.parametrize("jax_explicit", [True, False],
                         ids=["jax_explicit_sweep", "jax_jvp_replay"])
def test_dynamics_jacobians_against_jax(jax_explicit):
    jp = jmodel.make_rbd_arm_problem(explicit_derivatives=jax_explicit)
    tp = tmodel.make_rbd_arm_problem()
    x, u = states(2, 1)
    A, B = tp.dynamics_jacobians(to_torch(x), to_torch(u))
    assert A.shape == (16, 16, 2) and B.shape == (16, 8, 2)
    Aj, Bj = jp.dynamics_jacobians(jnp.asarray(x[:, 0]), jnp.asarray(u[:, 0]))
    close(A[..., 0], Aj, 1e-9, 1e-11)
    close(B[..., 0], Bj, 1e-9, 1e-11)
