"""``al_solve`` of the port on the 6-DoF arm, float64, CPU: the path that
runs the Riccati kernel past the padded ``(24, 12)``.

The augmented Lagrangian carries the step index as a state coordinate, so
the arm's n=24, m=12 reaches the backward pass as ``(25, 12)``: on the card
``csrc/riccati_large.cu``, here its plain version (``riccati_scan_cuda_
batched`` on CPU tensors).  B=2 scenarios of T=4 steps with the six joint
velocities capped at 0.01 (rows active at the start), one outer iteration
of three inner passes, Tassa regularization as ``chip_smoke.py`` runs it:

* ``backward_backend="pallas"`` against ``"scan"``: the first inner pass
  hands the batch-first entry ``(25, 12)`` models; every field of the
  result within the Riccati bar, rtol 1e-10 / atol 1e-12 (the plain
  version's ``rsqrt`` against the scan's ``sqrt`` and divide, ``ROADMAP.md``
  C3), the status and the multipliers' active set equal.
* The augmented cost's derivatives the first inner pass hands the kernel
  (lane 0, first step and terminal state) against the JAX package's
  augmented problem (``ilqr_tpu.al._augment_problem``) differentiated
  un-jitted on that one state (``ROADMAP.md`` C9: JAX compiles the 6-DoF
  programs for minutes on a CPU), rtol 1e-11 / atol 1e-12.  The dynamics
  Jacobians, 15 s un-jitted in JAX, have a file of their own
  (``tests/test_torch_al_6dof_jacobians.py``).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ilqr_tpu import al as jal
from ilqr_tpu.models.rbd import model as jmodel
from ilqr_tpu_torch import al
from ilqr_tpu_torch.config import ILQRConfig
from ilqr_tpu_torch.models.rbd import SIX_DOF_ARM_URDF, make_rbd_arm_problem
from ilqr_tpu_torch.ops import cuda_riccati, riccati_dispatch
from tests.torch_parity import assert_close, to_torch

torch.set_num_threads(1)

B, T, V_MAX = 2, 4, 0.01
TARGET = [0.0, 0.0, 0.0, 1.0, 1.0, 1.0] + [0.3] * 6
JOINTS = 6
P = 2 * JOINTS
# chip_smoke.rbd_config's Tassa flags, a 4-rung ladder.
FLAGS = dict(max_iter=3, tol=1e-5, tol_grad=1e-10, tol_grad_rel=1e-6,
             adaptive_reg=True, reg=1.0, reg_min=1e-3, reg_scale=10.0,
             reg_backtrack_trigger=1, max_backtracks=4)


def x0s():
    """The 6-DoF arm's nominal state with 0.02 of noise on every
    component (``scripts/bench_6dof.py``)."""

    rng = np.random.default_rng(6)
    nominal = np.array([0.0, 0.0, 1.0] + [0.0] * 21)
    return nominal + 0.02 * rng.standard_normal((B, 24))


def port_cap(x, u):
    # Components lead, batch axes trail (the arm takes trailing axes).
    v = torch.as_tensor(V_MAX, dtype=x.dtype, device=x.device)
    return torch.cat([x[-JOINTS:] - v, -x[-JOINTS:] - v])


def jax_cap(x, u):
    return jnp.concatenate([x[-JOINTS:] - V_MAX, -x[-JOINTS:] - V_MAX])


@functools.lru_cache(maxsize=None)
def port_problem():
    return make_rbd_arm_problem(target_pose=TARGET,
                                urdf_path=SIX_DOF_ARM_URDF)


@functools.lru_cache(maxsize=None)
def run(backend):
    """``(result, the batch-first models of the first backward pass or
    None)``; ``"pallas"`` records what the first pass hands the kernel's
    entry."""

    first = []
    entry = riccati_dispatch.riccati_scan_cuda_batched

    def recording(*args, **kw):
        if not first:
            first.append(args[:9])
        return entry(*args, **kw)

    riccati_dispatch.riccati_scan_cuda_batched = recording
    try:
        res = al.al_solve(port_problem(), to_torch(x0s()),
                          torch.zeros((B, T, 12), dtype=torch.float64),
                          port_cap,
                          config=ILQRConfig(backward_backend=backend,
                                            **FLAGS),
                          al_config=al.ALConfig(max_outer=1), device="cpu")
    finally:
        riccati_dispatch.riccati_scan_cuda_batched = entry
    return res, (first[0] if first else None)


def jax_augmented():
    """The JAX package's augmented 6-DoF problem with the first inner
    pass's multipliers (0) and penalty (``mu0``)."""

    jp = jmodel.make_rbd_arm_problem(
        target_pose=TARGET,
        urdf_path=os.path.join(jmodel.ASSET_DIR, "6Dof_arm.urdf"))
    return jal._augment_problem(
        jp, jax_cap, None, jnp.zeros((T, P)), jnp.zeros((1,)),
        jnp.float64(al.ALConfig().mu0), jnp.zeros((P,), bool),
        jnp.zeros((1,), bool), T)


def test_kernel_backend_equals_scan():
    res, models = run("pallas")
    ref, none = run("scan")
    # The kernel's entry saw the (25, 12) models; the scan backend never
    # reaches it.
    assert none is None
    assert models[0].shape == (B, T, 25, 25) and models[1].shape == (
        B, T, 25, 12)
    assert cuda_riccati.route(25, 12)[0] == "riccati_large"
    assert int(res.outer_iterations.max()) == 1
    assert int(res.inner_iterations.min()) >= 2
    # The cap binds: the first outer iteration leaves violated rows.
    assert float(res.max_violation.min()) > 0.0
    assert torch.equal(res.status, ref.status)
    assert torch.equal(res.lam > 0, ref.lam > 0)
    for name, a, b in zip(res._fields, res, ref):
        if a.is_floating_point():
            torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12,
                                       msg=name)
        else:
            assert torch.equal(a, b), name


def test_first_pass_cost_derivatives_against_jax():
    _, models = run("pallas")
    _As, _Bs, qx, ru, Qxx, Pux, Ruu, qxN, QN = (m[0] for m in models)
    jprob = jax_augmented()
    n = 25
    # Lane 0, step 0: the initial state with the step coordinate 0, the
    # initial controls (zero).
    xk = np.concatenate([x0s()[0], [0.0]])
    u = np.zeros(12)

    def cost_z(z):
        return jprob.cost(z[:n], z[n:])

    z = jnp.concatenate([jnp.asarray(xk), jnp.asarray(u)])
    g = jax.grad(cost_z)(z)
    Hz = jax.hessian(cost_z)(z)
    for name, a, b in zip(("qx", "ru", "Qxx", "Pux", "Ruu"),
                          (qx[0], ru[0], Qxx[0], Pux[0], Ruu[0]),
                          (g[:n], g[n:], Hz[:n, :n], Hz[n:, :n],
                           Hz[n:, n:])):
        assert_close(a, b, 1e-11, 1e-12, err_msg=name)
    # The terminal state of lane 0's initial rollout, from the port (the
    # JAX rollout takes 5 s a step un-jitted); its cost's derivatives.
    from ilqr_tpu_torch.problem import rollout

    xT = rollout(port_problem().dynamics, to_torch(x0s()[0]),
                 torch.zeros((T, 12), dtype=torch.float64))[-1]
    xkT = jnp.asarray(np.concatenate([xT.numpy(), [float(T)]]))
    assert_close(qxN, jax.grad(jprob.final_cost)(xkT), 1e-11, 1e-12,
                 err_msg="qxN")
    assert_close(QN, jax.hessian(jprob.final_cost)(xkT), 1e-11, 1e-12,
                 err_msg="QN")
