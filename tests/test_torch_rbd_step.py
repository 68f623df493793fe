"""One solver iteration of the floating-base arm, the slice as a whole:
the port's ``ilqr_step`` from JAX ``StepState``s, float64, CPU.

The RBD problem of both packages, ``bench.py``'s solver flags (Tassa
regularization: ``adaptive_reg``, ``reg=1``, ``reg_min=1e-3``,
``reg_scale=10``, ``reg_backtrack_trigger=1``), B=3 scenarios from the
benchmark's pose-only distribution, T=8.  From the JAX engine's state
before each of its first iterations, one iteration of the port gives the
JAX engine's next state: ``status`` and ``iterations`` equal, the line
search's backtracks equal, ``us``/``xs``/``prev_cost``/``reg`` to rtol 1e-8
(atol 1e-10 on ``us``) — one iteration at a time, so that a stiff scenario
cannot compound rounding over a whole solve.

The JAX side is kept as cheap as it gets: its explicit derivative sweep
(the replay agrees with it to rounding, ``tests/test_rbd_analytic_jvp.py``),
its scan backend (the Pallas kernel's interpret mode takes the CPU compiler
many minutes at n=16), the initial rollout taken from the port (dynamics
parity is ``tests/test_torch_rbd_model.py``'s), and ONE jitted step function
used for every iteration.  Tracing and compiling that one program still
takes four to five minutes on a CPU (turning the backend's expensive passes
off does not shorten it, and run eagerly the same step takes three times as
long), so this file is the slow one of the port's tests.  The port runs
``backward_backend="pallas"``, which on CPU tensors is the CUDA kernel's
plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ilqr_tpu import batched as jb
from ilqr_tpu.config import ILQRConfig as JaxConfig
from ilqr_tpu.models.rbd.model import make_rbd_arm_problem as jax_rbd_problem
from ilqr_tpu.step import ilqr_step as jax_ilqr_step
from ilqr_tpu.step import initial_state as jax_initial_state
from ilqr_tpu_torch import batched as tb
from ilqr_tpu_torch.convert import config_from_fields, step_state_from_numpy
from ilqr_tpu_torch.models.rbd import make_rbd_arm_problem
from ilqr_tpu_torch.ops import cuda_riccati
from ilqr_tpu_torch.step import ilqr_step
from tests.torch_parity import assert_close, to_torch

torch.set_num_threads(1)

B, T, N_STEPS = 3, 8, 2
NOMINAL = np.array([0.0, 0.0, 1.0, 0.5, 0.75, 1.0, 0.0, 0.0] + [0.0] * 8)
FLAGS = dict(max_iter=100, tol=1e-5, tol_grad=1e-10, tol_grad_rel=1e-6,
             adaptive_reg=True, reg=1.0, reg_min=1e-3, reg_scale=10.0,
             reg_backtrack_trigger=1)


def test_ilqr_step_of_the_rbd_problem_from_jax_states():
    rng = np.random.default_rng(0)
    noise = 0.05
    scale = np.array([0.4 * noise] * 3 + [noise] * 5 + [0.0] * 8)
    x0s = NOMINAL + scale * rng.standard_normal((B, 16))
    us0 = np.zeros((T, 8, B))

    tp = make_rbd_arm_problem()
    xs0 = tb.rollout_bl(tp, to_torch(x0s.T), to_torch(us0)).numpy()

    jp = jax_rbd_problem(explicit_derivatives=True)
    jcfg = JaxConfig(backward_backend="scan", **FLAGS)
    engine = jb.make_batch_last_engine(jp, None, jcfg)
    states = [jax_initial_state(jnp.asarray(xs0), jnp.asarray(us0), jcfg,
                                lane_shape=(B,))]
    jstep = jax.jit(lambda s: jax_ilqr_step(engine, jcfg, s))
    bts = []
    for _ in range(N_STEPS):
        nxt, aux = jstep(states[-1])
        states.append(nxt)
        bts.append(np.asarray(aux.backtracks))

    tcfg = config_from_fields(jcfg).replace(backward_backend="pallas")
    tengine = tb.make_batch_last_engine(tp, None, tcfg)
    before = cuda_riccati.launches()
    for i in range(N_STEPS):
        tstate = step_state_from_numpy(
            {k: np.asarray(v) for k, v in states[i]._asdict().items()},
            device="cpu")
        nxt, aux = ilqr_step(tengine, tcfg, tstate)
        for k, r in states[i + 1]._asdict().items():
            o = getattr(nxt, k)
            if k in ("iteration", "status"):
                assert o.dtype == torch.int32
                np.testing.assert_array_equal(o.numpy(), np.asarray(r), k)
            else:
                assert o.dtype == torch.float64
                assert_close(o, r, 1e-8, 1e-10 if k in ("us", "xs") else 0.0,
                             err_msg=f"step {i}: {k}")
        np.testing.assert_array_equal(aux.backtracks.numpy(), bts[i])
    assert cuda_riccati.launches() == before    # CPU tensors: plain version
    # The iterations did something: costs fell and the schedule moved.
    assert (np.asarray(states[-1].prev_cost)
            < np.asarray(states[1].prev_cost)).all()
    assert not np.array_equal(np.asarray(states[-1].reg),
                              np.asarray(states[0].reg))
