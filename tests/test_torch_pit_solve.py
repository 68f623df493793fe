"""A whole per-scenario solve with the port's parallel-in-time backward pass
(``backward_backend="associative"``, consistent regularization) against the
JAX package's, float64, CPU: the same status (CONVERGED) and iterations,
``us`` to rtol 1e-8 and the cost to rtol 1e-10.  (The recursion itself is
held against the JAX ``pit`` in ``tests/test_torch_pit.py``.)
"""

import jax.numpy as jnp
import numpy as np
import torch

from ilqr_tpu.config import ILQRConfig as JaxConfig
from ilqr_tpu.models.two_link import make_two_link_problem as jax_two_link
from ilqr_tpu.problem import rollout as jax_rollout
from ilqr_tpu.solver import solve as jax_solve
from ilqr_tpu_torch.convert import config_from_fields
from ilqr_tpu_torch.models.two_link import make_two_link_problem
from ilqr_tpu_torch.problem import problem_dynamics, rollout
from ilqr_tpu_torch.solver import solve
from tests.torch_parity import NOMINAL, assert_close, jit_once, to_torch

torch.set_num_threads(1)


def test_whole_solve_against_jax():
    flags = dict(backward_backend="associative", reg=1e-2, reg_in_value=True,
                 max_iter=30, tol=1e-6, tol_grad=1e-10, tol_grad_rel=1e-6)
    rng = np.random.default_rng(4)
    T = 10
    x0 = NOMINAL + 0.1 * rng.standard_normal(4)
    us0 = 0.1 * rng.standard_normal((T, 2))
    jp = jax_two_link()
    jx0, jus0 = jnp.asarray(x0), jnp.asarray(us0)

    def one(a, u):
        return jax_solve(jp, jax_rollout(jp.dynamics, a, u), u,
                         config=JaxConfig(**flags))

    ref = jit_once(one, jx0, jus0)
    tp = make_two_link_problem()
    xs0 = rollout(lambda x, u: problem_dynamics(tp, x, u), to_torch(x0),
                  to_torch(us0))
    res = solve(tp, xs0, to_torch(us0), config=config_from_fields(flags),
                device="cpu")
    assert int(res.status) == int(ref.status) == 1
    assert int(res.iterations) == int(ref.iterations)
    assert_close(res.us, ref.us, 1e-8, 1e-10)
    assert_close(res.cost, ref.cost, 1e-10)
