"""The port's control box (``constraints.box_constrained``) and cost library
(``costs``), float64, CPU, against the JAX package's, and ``al_solve`` of
the 2-link with a control box and a velocity cap against
``ilqr_tpu.al.al_solve``.

* every cost builder: value, gradient and Hessian at random points against
  the JAX builder's (``jax.grad``/``jax.hessian``), rtol 1e-12;
* the squash: ``to_u``, ``to_v`` and the squashed problem's dynamics and
  cost, their Jacobians through the port's derivative sweeps against
  ``jax.jacfwd``; the analytic hooks of the base problem are dropped;
* float32 stays float32 inside ``jacfwd`` under ``vmap`` (no tensor of more
  than 0 dims is produced in float64, ``ROADMAP.md`` C4, C8);
* ``al_solve`` over the squashed 2-link with a joint-velocity cap: the
  final result against the JAX package's, the integers identical, the rest
  to rtol 1e-8, the controls inside the box and the largest violation at or
  below the target.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ilqr_tpu import costs as jcosts
from ilqr_tpu.al import ALConfig as JaxALConfig
from ilqr_tpu.al import al_solve as jax_al_solve
from ilqr_tpu.config import ILQRConfig as JaxConfig
from ilqr_tpu.constraints import box_constrained as jax_box
from ilqr_tpu.models.two_link import make_two_link_problem as jax_two_link
from ilqr_tpu_torch import costs
from ilqr_tpu_torch.al import ALConfig, al_solve
from ilqr_tpu_torch.constraints import box_constrained
from ilqr_tpu_torch.convert import config_from_fields
from ilqr_tpu_torch.derivatives import (problem_linearize,
                                        problem_quadratize_final,
                                        problem_quadratize_running)
from ilqr_tpu_torch.models.two_link import make_two_link_problem
from ilqr_tpu_torch.problem import Problem
from tests.torch_parity import assert_close, jit_fast, jit_once, to_torch

torch.set_num_threads(1)

RNG = np.random.default_rng(0)
Q_DIAG = np.array([1.0, 0.5, 0.1, 0.2])
Q_FULL = np.diag(Q_DIAG) + 0.05
R_DIAG = np.array([0.01, 0.02])
TARGET = np.array([np.pi, 0.1])


def fk(x, lib):
    return lib.stack([lib.cos(x[0]) + lib.cos(x[0] + x[1]),
                      lib.sin(x[0]) + lib.sin(x[0] + x[1])])


BUILDERS = {
    "tracking_diag": (lambda m: m.quadratic_tracking_cost(Q_DIAG, R_DIAG),
                      2),
    "tracking_full_target": (
        lambda m: m.quadratic_tracking_cost(Q_FULL[:2, :2], np.diag(R_DIAG),
                                            target=TARGET), 2),
    "final": (lambda m: m.quadratic_final_cost(Q_DIAG[:2], target=TARGET,
                                               weight=1e5), 1),
    "final_full": (lambda m: m.quadratic_final_cost(Q_FULL), 1),
    "effort": (lambda m: m.effort_cost(0.3), 2),
    "workspace": (lambda m: m.workspace_target_final_cost(
        lambda x: fk(x, torch if m is costs else jnp), [0.5, 1.2],
        weight=7.0), 1),
    "sum": (lambda m: m.add_costs(m.effort_cost(0.3),
                                  m.quadratic_tracking_cost(Q_DIAG, R_DIAG)),
            2),
}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_cost_values_and_derivatives(name):
    build, n_args = BUILDERS[name]
    port, ref = build(costs), build(jcosts)
    argnums = tuple(range(n_args))
    example = [jnp.zeros(4), jnp.zeros(2)][:n_args]
    j_value = jit_fast(ref, *example)
    j_grad = jit_fast(jax.grad(ref, argnums=argnums), *example)
    j_hess = jit_fast(jax.hessian(ref, argnums=argnums), *example)
    for _ in range(3):
        args = [RNG.standard_normal(4), RNG.standard_normal(2)][:n_args]
        t_args = [to_torch(a) for a in args]
        j_args = [jnp.asarray(a) for a in args]
        assert_close(port(*t_args), j_value(*j_args), 1e-12)
        tg = torch.func.grad(port, argnums=argnums)(*t_args)
        jg = j_grad(*j_args)
        for a, b in zip(tg, jg):
            assert_close(a, b, 1e-12, 1e-14)
        th = torch.func.hessian(port, argnums=argnums)(*t_args)
        jh = j_hess(*j_args)
        for i in argnums:
            for j in argnums:
                assert_close(th[i][j], jh[i][j], 1e-11, 1e-13)


@pytest.mark.parametrize("bounds", [(-2.0, 2.0),
                                    (np.array([-1.0, -3.0]),
                                     np.array([2.0, 0.5]))],
                         ids=["scalar", "per_control"])
def test_box_values_and_jacobians(bounds):
    lo, hi = bounds
    tp, to_u, to_v = box_constrained(make_two_link_problem(), lo, hi)
    jp, jto_u, jto_v = jax_box(jax_two_link(), lo, hi)
    assert tp.dynamics_jacobians is None and tp.cost_quadratization is None
    assert tp.batch_trailing  # kept from the base 2-link problem
    v = 2.0 * RNG.standard_normal((5, 2))
    u = 4.0 * RNG.standard_normal((5, 2))
    x = np.array([0.3, 0.7, 0.2, 0.5]) + 0.2 * RNG.standard_normal((5, 4))
    assert_close(to_u(to_torch(v)), jto_u(jnp.asarray(v)), 1e-14)
    assert_close(to_v(to_torch(u)), jto_v(jnp.asarray(u)), 1e-12)
    assert bool((to_u(to_torch(v)) > to_torch(lo)).all())
    assert bool((to_u(to_torch(v)) < to_torch(hi)).all())
    As, Bs = problem_linearize(tp, to_torch(x), to_torch(v))
    quad = problem_quadratize_running(tp, to_torch(x), to_torch(v))
    jA, jB = jit_once(jax.vmap(jax.jacfwd(jp.dynamics, argnums=(0, 1))),
                      jnp.asarray(x), jnp.asarray(v))
    assert_close(As, jA, 1e-11, 1e-13)
    assert_close(Bs, jB, 1e-11, 1e-13)
    jru = jit_once(jax.vmap(jax.grad(jp.cost, argnums=1)), jnp.asarray(x),
                   jnp.asarray(v))
    assert_close(quad[2], jru, 1e-11, 1e-13)


class _RecordDtypes(TorchDispatchMode):
    """The dtypes of every tensor of more than 0 dims any operation
    produces (as in ``tests/test_torch_rbd_model.py``)."""

    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for o in (out if isinstance(out, (tuple, list)) else (out,)):
            if (isinstance(o, torch.Tensor) and o.is_floating_point()
                    and o.ndim > 0):
                self.seen.add(o.dtype)
        return out


def test_float32_stays_float32_under_jacfwd():
    """A double integrator written with 0-d tensors of the working type,
    squashed, with costs of the library: the per-scenario sweeps of the
    derivatives produce nothing in float64."""

    def dynamics(x, u):
        dt = torch.as_tensor(0.1, dtype=x.dtype, device=x.device)
        return x + dt * torch.cat([x[2:], u])

    cost = costs.add_costs(costs.effort_cost(0.3),
                           costs.quadratic_tracking_cost(Q_DIAG, R_DIAG))
    final = costs.quadratic_final_cost(Q_DIAG[:2], target=TARGET, weight=1e3)
    base = Problem(dynamics=dynamics, cost=cost, final_cost=final)
    tp, _, _ = box_constrained(base, -2.0, np.array([2.0, 1.0]))
    x = torch.tensor(0.1 * RNG.standard_normal((6, 4)), dtype=torch.float32)
    v = torch.tensor(RNG.standard_normal((6, 2)), dtype=torch.float32)
    rec = _RecordDtypes()
    with rec:
        outs = (problem_linearize(tp, x, v)
                + problem_quadratize_running(tp, x, v)
                + problem_quadratize_final(tp, x))
    assert rec.seen == {torch.float32}, rec.seen
    assert {o.dtype for o in outs} == {torch.float32}


def test_al_solve_with_a_box_against_jax():
    T, vmax = 16, 0.6
    x0 = np.array([0.3, 0.7, 0.2, 0.5])
    flags = dict(max_iter=30, tol=1e-6, tol_grad=1e-10, tol_grad_rel=1e-6)
    tp, to_u, _ = box_constrained(make_two_link_problem(), -1.5, 1.5)
    jp, jto_u, _ = jax_box(jax_two_link(), -1.5, 1.5)

    def port_c(x, u):
        cap = torch.as_tensor(vmax, dtype=x.dtype, device=x.device)
        return torch.cat([x[2:] - cap, -x[2:] - cap])

    def jax_c(x, u):
        return jnp.concatenate([x[2:] - vmax, -x[2:] - vmax])

    res = al_solve(tp, to_torch(x0), torch.zeros((T, 2), dtype=torch.float64),
                   port_c, config=config_from_fields(flags),
                   al_config=ALConfig(max_outer=8), device="cpu")
    ref = jit_once(lambda a, b: jax_al_solve(
        jp, a, b, jax_c, config=JaxConfig(**flags),
        al_config=JaxALConfig(max_outer=8)), jnp.asarray(x0),
        jnp.zeros((T, 2)))
    for name in ("outer_iterations", "inner_iterations", "status"):
        assert int(getattr(res, name)) == int(getattr(ref, name)), name
    for name in ("xs", "us", "lam", "lam_T", "mu"):
        assert_close(getattr(res, name), getattr(ref, name), 1e-8, 1e-10,
                     err_msg=name)
    assert_close(res.cost, ref.cost, 1e-10)
    assert float(res.max_violation) <= ALConfig().constraint_tol
    assert int(res.status) == 1
    u = to_u(res.us)
    assert bool((u.abs() < 1.5).all())
    assert float(res.lam.max()) > 0.0
