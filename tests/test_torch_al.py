"""The port's augmented-Lagrangian outer loop (``ilqr_tpu_torch.al``),
float64, CPU, against the JAX package's ``ilqr_tpu.al``.

The 2-link arm at T=20 with a joint-velocity cap (inequality rows) and a
terminal elbow velocity of zero (an equality row), a scenario whose inner
solves converge (``tol_grad_rel`` on, ``ROADMAP.md`` C11) and whose outer
loop converges in eight iterations with the cap active:

* the multipliers, penalty and controls after EVERY outer iteration against
  the JAX outer iteration (``ilqr_tpu.al._augment_problem``, ``rollout``
  and ``solve`` with the dual update of ``al_solve``, compiled once and
  stepped), rtol 1e-8; the port's are read as each outer iteration hands
  them to ``_augment_problem``.  (``ilqr_tpu.al.al_solve`` itself is held
  against the port in ``tests/test_torch_constraints_costs.py``.)
* a batch of scenarios on a leading axis — the index coordinate then starts
  at ``lane * T``, and the callables take the batch as trailing axes —
  against each scenario solved alone through per-scenario callables;
* the augmented problem's cost and its derivatives against the JAX one at a
  state with active and inactive rows;
* float32 in, float32 out; a float32 batch too large for the step
  coordinate to stay an exact integer solved in sub-batches, and one
  scenario too long for it refused;
* a batch split into sub-batches (the limit lowered) equal to the same
  batch unsplit.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_tpu import al as jal
from ilqr_tpu.config import ILQRConfig as JaxConfig
from ilqr_tpu.config import Status as JaxStatus
from ilqr_tpu.models.two_link import make_two_link_problem as jax_two_link
from ilqr_tpu.problem import rollout as jax_rollout
from ilqr_tpu.solver import solve as jax_solve
from ilqr_tpu_torch import al
from ilqr_tpu_torch.convert import config_from_fields
from ilqr_tpu_torch.derivatives import quadratize_running_cost
from ilqr_tpu_torch.models.two_link import make_two_link_problem
from tests.torch_parity import assert_close, jit_fast, jit_once, to_torch

torch.set_num_threads(1)

T, VMAX = 20, 0.6
X0 = np.array([0.3, 0.7, 0.2, 0.5])
FLAGS = dict(max_iter=30, tol=1e-6, tol_grad=1e-10, tol_grad_rel=1e-6)
MAX_OUTER = 10
EQ_T = [True]


def jax_c(x, u):
    return jnp.concatenate([x[2:] - VMAX, -x[2:] - VMAX])


def jax_cT(x):
    return x[3:4]


def port_c(x, u):
    v = torch.as_tensor(VMAX, dtype=x.dtype, device=x.device)
    return torch.cat([x[2:] - v, -x[2:] - v])


def port_cT(x):
    return x[3:4]


def port_run(dtype=torch.float64, max_outer=MAX_OUTER, x0=X0,
             trailing=True):
    x0 = to_torch(x0).to(dtype)
    problem = dataclasses.replace(make_two_link_problem(),
                                  batch_trailing=trailing)
    return al.al_solve(problem, x0,
                       torch.zeros(x0.shape[:-1] + (T, 2), dtype=dtype),
                       port_c, port_cT,
                       equality_mask_T=EQ_T,
                       config=config_from_fields(FLAGS),
                       al_config=al.ALConfig(max_outer=max_outer),
                       device="cpu")


@functools.lru_cache(maxsize=None)
def port_trace():
    """The port's final result and the (lam, lam_T, mu) each outer
    iteration starts from."""

    seen = []
    original = al._augment_problem

    def recording(problem, c, cT, lam_rows, lam_T_rows, mu_rows, *rest):
        seen.append((lam_rows.clone(), lam_T_rows[0].clone(),
                     mu_rows[0].clone()))
        return original(problem, c, cT, lam_rows, lam_T_rows, mu_rows, *rest)

    al._augment_problem = recording
    try:
        res = port_run()
    finally:
        al._augment_problem = original
    return res, seen


@functools.lru_cache(maxsize=None)
def jax_trace():
    """JAX's outer iteration, compiled once and stepped ``MAX_OUTER`` times:
    the carry after each (lam, lam_T, mu, us, done)."""

    problem = jax_two_link()
    cfg = JaxConfig(**FLAGS)
    alc = jal.ALConfig(max_outer=MAX_OUTER)
    is_eq = jnp.zeros((4,), bool)
    is_eq_T = jnp.asarray(EQ_T)
    x0 = jnp.asarray(X0)

    def outer(lam, lam_T, mu, us, prev_viol, done):
        prob = jal._augment_problem(problem, jax_c, jax_cT, lam, lam_T, mu,
                                    is_eq, is_eq_T, T)
        x0_aug = jnp.concatenate([x0, jnp.zeros((1,))])
        res = jax_solve(prob, jax_rollout(prob.dynamics, x0_aug, us), us,
                        config=cfg)
        xs = res.xs[:, :-1]
        c = jax.vmap(jax_c)(xs[:-1], res.us)
        cT = jax_cT(xs[-1])
        viol = jnp.maximum(jnp.max(jal._violation(c, is_eq[None, :])),
                           jnp.max(jal._violation(cT, is_eq_T)))
        lam_new = jnp.clip(jnp.where(is_eq[None, :], lam + mu * c,
                                     jnp.maximum(lam + mu * c, 0.0)),
                           -alc.lam_max, alc.lam_max)
        lam_T_new = jnp.clip(jnp.where(is_eq_T, lam_T + mu * cT,
                                       jnp.maximum(lam_T + mu * cT, 0.0)),
                             -alc.lam_max, alc.lam_max)
        feasible = viol <= alc.constraint_tol
        slow = viol > alc.viol_decrease * prev_viol
        mu_new = jnp.where(jnp.logical_and(~feasible, slow),
                           jnp.minimum(mu * alc.mu_scale, alc.mu_max), mu)
        done_now = jnp.logical_and(
            feasible, res.status != int(JaxStatus.LINESEARCH_FAILED))
        keep = done
        return (jnp.where(keep, lam, lam_new),
                jnp.where(keep, lam_T, lam_T_new),
                jnp.where(keep, mu, mu_new),
                jnp.where(keep, us, res.us),
                jnp.where(keep, prev_viol, viol),
                jnp.logical_or(done, done_now))

    carry = (jnp.zeros((T, 4)), jnp.zeros((1,)), jnp.float64(alc.mu0),
             jnp.zeros((T, 2)), jnp.float64(jnp.inf), jnp.bool_(False))
    outer = jit_fast(outer, *carry)
    steps = []
    for _ in range(MAX_OUTER):
        carry = outer(*carry)
        steps.append(tuple(np.asarray(a) for a in carry))
    return steps


def test_multipliers_after_every_outer_iteration():
    res, seen = port_trace()
    steps = jax_trace()
    n_ran = int(res.outer_iterations)
    assert 3 <= n_ran < MAX_OUTER, n_ran
    # The port hands iteration k the multipliers after iteration k-1.
    for k in range(1, n_ran):
        lam, lam_T, mu = seen[k]
        jlam, jlam_T, jmu = steps[k - 1][:3]
        assert_close(lam, jlam, 1e-8, 1e-10, err_msg=f"lam after {k}")
        assert_close(lam_T, jlam_T, 1e-8, 1e-10, err_msg=f"lam_T after {k}")
        assert_close(mu, jmu, 1e-12, err_msg=f"mu after {k}")
    assert bool(steps[n_ran - 1][5]) and not bool(steps[n_ran - 2][5])
    # ... and after the last one, the result's.
    assert_close(res.lam, steps[n_ran - 1][0], 1e-8, 1e-10)
    assert_close(res.us, steps[n_ran - 1][3], 1e-8, 1e-10)
    assert float(steps[n_ran - 1][0].max()) > 0.0   # the cap was active


def test_batch_against_each_scenario_alone():
    """The batch on the 2-link's trailing axes (the constraints called on
    whole batches) against each scenario alone through ``torch.func.vmap``
    of per-scenario callables."""

    rng = np.random.default_rng(1)
    x0s = X0 + 0.05 * rng.standard_normal((2, 4))
    batch = port_run(x0=x0s, max_outer=3)
    for b in range(2):
        one = port_run(x0=x0s[b], max_outer=3, trailing=False)
        for name, x, y in zip(one._fields, batch, one):
            torch.testing.assert_close(x[b], y, rtol=1e-10, atol=1e-12,
                                       msg=name)


@pytest.mark.parametrize("lam_scale", [0.0, 1.0])
def test_augmented_cost_and_derivatives(lam_scale):
    rng = np.random.default_rng(3)
    lam = lam_scale * np.abs(rng.standard_normal((T, 4)))
    lam_T, mu, k = np.array([0.5]), 10.0, 7
    xk = np.concatenate([X0 + np.array([0, 0, 0.5, -0.9]), [float(k)]])
    u = rng.standard_normal(2)
    jprob = jal._augment_problem(jax_two_link(), jax_c, jax_cT,
                                 jnp.asarray(lam), jnp.asarray(lam_T),
                                 jnp.float64(mu), jnp.zeros((4,), bool),
                                 jnp.asarray(EQ_T), T)
    tprob = al._augment_problem(
        make_two_link_problem(), port_c, port_cT, to_torch(lam),
        to_torch(lam_T), to_torch([mu]), torch.zeros(4, dtype=torch.bool),
        torch.tensor(EQ_T), T)
    assert_close(tprob.cost(to_torch(xk), to_torch(u)),
                 jprob.cost(jnp.asarray(xk), jnp.asarray(u)), 1e-13)
    assert_close(tprob.final_cost(to_torch(xk)),
                 jprob.final_cost(jnp.asarray(xk)), 1e-13)
    assert_close(tprob.dynamics(to_torch(xk), to_torch(u)),
                 jprob.dynamics(jnp.asarray(xk), jnp.asarray(u)), 1e-13)
    quad = quadratize_running_cost(tprob.cost, to_torch(xk)[None],
                                   to_torch(u)[None])
    z = jnp.concatenate([jnp.asarray(xk), jnp.asarray(u)])
    n = xk.shape[0]

    def cost_z(z):
        return jprob.cost(z[:n], z[n:])

    g = jit_once(jax.grad(cost_z), z)
    Hz = jit_once(jax.hessian(cost_z), z)
    for name, a, b in zip(("qx", "ru", "Qxx", "Pux", "Ruu"), quad[1:],
                          (g[:n], g[n:], Hz[:n, :n], Hz[n:, :n],
                           Hz[n:, n:])):
        assert_close(a[0], b, 1e-11, 1e-12, err_msg=name)


def test_float32_in_float32_out():
    res = port_run(torch.float32, max_outer=2)
    for name in ("xs", "us", "cost", "max_violation", "lam", "lam_T", "mu"):
        assert getattr(res, name).dtype == torch.float32, name
    for name in ("outer_iterations", "inner_iterations", "status"):
        assert getattr(res, name).dtype == torch.int32, name


def test_float32_step_coordinate_must_stay_exact(monkeypatch):
    """2^24 / (T + 1) scenarios number the coordinate up to 2^24 - T - 1, the
    last float32 batch that holds it exactly; one more is solved in two
    sub-batches, each numbering its steps from 0.  A single scenario whose
    T + 1 reaches 2^24 is refused before any solve."""

    problem = make_two_link_problem()
    lanes = 2 ** 24 // (T + 1)
    assert al._exact_lanes(torch.float32, T) == lanes
    us = torch.zeros((T, 2), dtype=torch.float32)

    def stop(x, u):
        raise StopIteration

    # The largest batch that holds it is not split: it passes the check and
    # reaches the constraint dimensions (the solve itself is not run here).
    x0 = torch.zeros((lanes, 4), dtype=torch.float32)
    with pytest.raises(StopIteration):
        al.al_solve(problem, x0, us, stop, port_cT, device="cpu")
    # One more is handed on as two sub-batches.
    original, sizes = al.al_solve, []

    def sub_batch(problem, x0, *args):
        sizes.append(x0.shape[0])
        raise StopIteration

    monkeypatch.setattr(al, "al_solve", sub_batch)
    x0 = torch.zeros((lanes + 1, 4), dtype=torch.float32)
    with pytest.raises(StopIteration):
        original(problem, x0, us, port_c, port_cT, device="cpu")
    assert sizes == [lanes]
    monkeypatch.setattr(al, "al_solve", original)
    long_T = 2 ** 24 - 1
    u_long = torch.zeros((1, 2), dtype=torch.float32).expand(long_T, 2)
    with pytest.raises(ValueError, match="exactly"):
        al.al_solve(problem, torch.zeros(4), u_long, port_c, port_cT,
                    device="cpu")


def test_split_batch_equals_unsplit(monkeypatch):
    """Five scenarios solved in sub-batches of two (the limit lowered) and
    in one batch: the same result, lane for lane."""

    rng = np.random.default_rng(5)
    x0s = X0 + 0.05 * rng.standard_normal((5, 4))
    whole = port_run(x0=x0s, max_outer=3)
    seen = []
    original = al._augment_problem

    def recording(problem, c, cT, lam_rows, lam_T_rows, mu_rows, *rest):
        seen.append(mu_rows.shape[0])
        return original(problem, c, cT, lam_rows, lam_T_rows, mu_rows, *rest)

    monkeypatch.setattr(al, "_exact_lanes", lambda dtype, T: 2)
    monkeypatch.setattr(al, "_augment_problem", recording)
    split = port_run(x0=x0s, max_outer=3)
    assert set(seen) == {2, 1}
    assert torch.equal(split.status, whole.status)
    for name in ("outer_iterations", "inner_iterations"):
        assert torch.equal(getattr(split, name), getattr(whole, name)), name
    for name, a, b in zip(whole._fields, split, whole):
        assert a.shape == b.shape, name
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12, msg=name)
