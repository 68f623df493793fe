"""The dynamics Jacobians the first inner pass of the port's ``al_solve``
hands the Riccati kernel on the 6-DoF arm (``(25, 12)`` with the step
index), against the JAX package's augmented problem, float64, CPU.

``tests/test_torch_al_6dof.py`` holds the rest of that pass's local models;
this file holds ``A [25, 25]`` and ``B [25, 12]`` of lane 0 at its first
step.  JAX differentiates ``ilqr_tpu.al._augment_problem``'s dynamics
un-jitted on that one state (``ROADMAP.md`` C9): a whole ``jax.jacfwd``
takes 16 to 29 s there and its jitted program 30 s to compile, so the JAX
side is two ``jax.jvp`` along seeded random directions, ``A dx`` and
``B du`` (10 and 5 s), which a wrong entry of either matrix moves.  Bar:
rtol 1e-9 / atol 1e-10, that of ``tests/test_torch_rbd_jacobians.py`` (the
two sides differentiate the same RK4 step by forward mode through different
algebra).  The index coordinate's row and column are exactly ``[0 ... 0 1]``
and zeros.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests.test_torch_al_6dof import jax_augmented, run, x0s
from tests.torch_parity import assert_close, to_torch

torch.set_num_threads(1)


def test_first_pass_dynamics_jacobians_against_jax():
    _, models = run("pallas")
    A, B = models[0][0, 0], models[1][0, 0]
    assert torch.equal(A[-1], torch.eye(25, dtype=A.dtype)[-1])
    assert not A[:-1, -1].any() and not B[-1].any()
    jprob = jax_augmented()
    xk = jnp.asarray(np.concatenate([x0s()[0], [0.0]]))
    u = jnp.zeros(12)
    rng = np.random.default_rng(25)
    dx, du = rng.standard_normal(25), rng.standard_normal(12)
    _, Adx = jax.jvp(jprob.dynamics, (xk, u),
                     (jnp.asarray(dx), jnp.zeros(12)))
    _, Bdu = jax.jvp(jprob.dynamics, (xk, u),
                     (jnp.zeros(25), jnp.asarray(du)))
    assert_close(A @ to_torch(dx), Adx, 1e-9, 1e-10, err_msg="A dx")
    assert_close(B @ to_torch(du), Bdu, 1e-9, 1e-10, err_msg="B du")
