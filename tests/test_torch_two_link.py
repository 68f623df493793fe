"""``ilqr_tpu_torch.models.two_link`` against ``ilqr_tpu.models.two_link``:
the same numpy states and controls through both, float64 on the CPU, rtol
1e-12 (identical closed-form expressions; libm's sin/cos may differ in the
last bit)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_tpu.models import two_link as jtl
from ilqr_tpu_torch.convert import two_link_params_from_fields
from ilqr_tpu_torch.models import two_link as ttl
from tests.torch_parity import assert_close, to_torch

RTOL = 1e-12
ATOL = 1e-14  # entries that are exactly zero on one side


def _points(k, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((k, 4)), rng.standard_normal((k, 2))


@pytest.fixture(params=[True, False], ids=["faithful", "full_coriolis"])
def params(request):
    jp = jtl.TwoLinkParams(faithful_coriolis=request.param, dt=0.02)
    return jp, two_link_params_from_fields(jp)


def test_params_cross(params):
    jp, tp = params
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    for name in ("alpha", "beta", "delta", "r1", "r2", "Iz1", "Iz2"):
        assert getattr(tp, name) == getattr(jp, name)


def test_kinematics_and_inertia(params):
    jp, tp = params
    xs, _ = _points(4)
    target = np.array([0.6, -0.5])
    assert_close(ttl.inverse_kinematics(tp, to_torch(target)),
                 jtl.inverse_kinematics(jp, jnp.asarray(target)), RTOL)
    for x in xs:
        th_j, th_t = jnp.asarray(x[:2]), to_torch(x[:2])
        for a, b in zip(ttl.forward_kinematics(tp, th_t),
                        jtl.forward_kinematics(jp, th_j)):
            assert_close(a, b, RTOL)
        assert_close(ttl.inertia_matrix(tp, th_t),
                     jtl.inertia_matrix(jp, th_j), RTOL)
        assert_close(ttl.inertia_matrix_grad(tp, th_t),
                     jtl.inertia_matrix_grad(jp, th_j), RTOL, ATOL)
        assert_close(
            ttl.coriolis_matrix(tp, th_t, to_torch(x[2:])),
            jtl.coriolis_matrix(jp, th_j, jnp.asarray(x[2:])), RTOL, ATOL)


def test_inertia_matrix_grad_is_the_jacobian(params):
    _, tp = params
    th = to_torch([0.4, -1.1])
    auto = torch.func.jacfwd(lambda t: ttl.inertia_matrix(tp, t))(th)
    assert_close(ttl.inertia_matrix_grad(tp, th), auto, RTOL, ATOL)


def test_dynamics_per_scenario_and_batch_trailing(params):
    jp, tp = params
    xs, us = _points(6, seed=1)
    ref_c = jax.vmap(lambda x, u: jtl.continuous_dynamics(jp, x, u))(
        jnp.asarray(xs), jnp.asarray(us))
    jdyn = jtl.make_dynamics(jp)
    ref = jax.vmap(jdyn)(jnp.asarray(xs), jnp.asarray(us))
    tdyn = ttl.make_dynamics(tp)

    # One scenario at a time ...
    for i in range(len(xs)):
        assert_close(ttl.continuous_dynamics(tp, to_torch(xs[i]),
                                             to_torch(us[i])), ref_c[i], RTOL)
        assert_close(tdyn(to_torch(xs[i]), to_torch(us[i])), ref[i], RTOL)
    # ... and directly on batch-trailing tensors [4, B], [4, 2, 3].
    assert_close(tdyn(to_torch(xs.T), to_torch(us.T)), np.asarray(ref).T, RTOL)
    x3 = to_torch(xs.T.reshape(4, 2, 3))
    u3 = to_torch(us.T.reshape(2, 2, 3))
    assert_close(tdyn(x3, u3), np.asarray(ref).T.reshape(4, 2, 3), RTOL)


def test_dynamics_jacobians(params):
    jp, tp = params
    xs, us = _points(3, seed=2)
    jjac = jax.jacfwd(jtl.make_dynamics(jp), argnums=(0, 1))
    tjac = torch.func.jacfwd(ttl.make_dynamics(tp), argnums=(0, 1))
    for x, u in zip(xs, us):
        A_ref, B_ref = jjac(jnp.asarray(x), jnp.asarray(u))
        A, B = tjac(to_torch(x), to_torch(u))
        assert_close(A, A_ref, 1e-11, ATOL)
        assert_close(B, B_ref, 1e-11, ATOL)


@pytest.mark.parametrize("analytic", [True, False])
def test_costs_and_quadratization_hooks(params, analytic):
    jp, tp = params
    jprob = jtl.make_two_link_problem(jp, analytic_cost_derivatives=analytic)
    tprob = ttl.make_two_link_problem(tp, analytic_cost_derivatives=analytic)
    assert (tprob.cost_quadratization is not None) == analytic
    assert tprob.state_dim == jprob.state_dim == 4
    assert tprob.control_dim == jprob.control_dim == 2
    xs, us = _points(4, seed=3)
    for x, u in zip(xs, us):
        xj, uj, xt, ut = jnp.asarray(x), jnp.asarray(u), to_torch(x), to_torch(u)
        assert_close(tprob.cost(xt, ut), jprob.cost(xj, uj), RTOL)
        assert_close(tprob.final_cost(xt), jprob.final_cost(xj), RTOL)
        if analytic:
            for a, b in zip(tprob.cost_quadratization(xt, ut),
                            jprob.cost_quadratization(xj, uj)):
                assert_close(a, b, RTOL)
            for a, b in zip(tprob.final_cost_quadratization(xt),
                            jprob.final_cost_quadratization(xj)):
                assert_close(a, b, RTOL)
    # Batch-trailing costs: [4, B] and [4, T, B].
    ref = jax.vmap(jprob.cost)(jnp.asarray(xs), jnp.asarray(us))
    assert_close(tprob.cost(to_torch(xs.T), to_torch(us.T)), ref, RTOL)
    assert_close(tprob.cost(to_torch(xs.T.reshape(4, 2, 2)),
                            to_torch(us.T.reshape(2, 2, 2))),
                 np.asarray(ref).reshape(2, 2), RTOL)
    assert_close(tprob.final_cost(to_torch(xs.T)),
                 jax.vmap(jprob.final_cost)(jnp.asarray(xs)), RTOL)


def test_float32_inputs_give_float32_everywhere():
    """Constants are built on the input's dtype: nothing widens to float64."""

    prob = ttl.make_two_link_problem()
    x = torch.tensor([0.3, 0.7, 0.2, 0.5], dtype=torch.float32)
    u = torch.tensor([0.1, -0.2], dtype=torch.float32)
    outs = (prob.dynamics(x, u), prob.cost(x, u), prob.final_cost(x),
            *prob.cost_quadratization(x, u),
            *prob.final_cost_quadratization(x))
    assert all(o.dtype == torch.float32 for o in outs)
