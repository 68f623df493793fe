"""The port's floating-base arm against the committed RBD goldens, float64,
CPU (the checks of ``tests/test_rbd_converged.py`` and
``tests/test_fixtures.py::test_rbd_T500_fixture_parity``).

``tests/fixtures/rbd_T1000_converged.npz`` is a converged solve at the
reference example's scale (N=1000, dt=0.01, pose target [0,0,0,5,1,2,1,.3]):

* the fixture point itself: its final pose at the target, its cost
  reproduced by the port's cost (rtol 1e-9) and its states by the port's
  rollout of its controls (rtol 1e-7, atol 1e-8);
* first-order stationarity: one backward pass of the port at the fixture
  predicts a linear decrease of at most 1e-4 of the cost.

``tests/fixtures/rbd_T500.npz`` (25 iterations of the oracle at T=500) is
re-solved by the port under the fixture's stopping rule: ``us`` within the
1e-3 parity budget, cost to rtol 1e-8.  That solve takes minutes on a CPU
(one rollout of T=500 alone takes seconds, and every iteration runs a
ladder of them), so it is marked ``slow`` here; ``chip_smoke.py`` runs it
on the card.
"""

import os

import numpy as np
import pytest
import torch

from ilqr_tpu_torch.backward import backward_pass
from ilqr_tpu_torch.config import ILQRConfig
from ilqr_tpu_torch.models.rbd.model import make_rbd_arm_problem
from ilqr_tpu_torch.problem import problem_dynamics, rollout, total_cost
from ilqr_tpu_torch.solver import solve

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
TARGET = np.array([0.0, 0.0, 0.0, 5.0, 1.0, 2.0, 1.0, 0.3])
CONFIG = ILQRConfig(max_iter=100, tol=1e-5, tol_grad=1e-10,
                    tol_grad_rel=1e-6, adaptive_reg=True, reg=1.0,
                    reg_min=1e-3, reg_scale=10.0, reg_backtrack_trigger=1)
PARITY_BUDGET = 1e-3   # BASELINE.md: |u - u_ref|_inf < 1e-3


def load(name):
    return np.load(os.path.join(FIXTURES, f"{name}.npz"))


def test_fixture_is_converged_solution():
    fx = load("rbd_T1000_converged")
    xs, us = fx["xs"], fx["us"]
    assert xs.shape == (1001, 16) and us.shape == (1000, 8)
    assert np.abs(xs[-1, :8] - TARGET).max() < 2e-2
    problem = make_rbd_arm_problem()
    cost = float(total_cost(problem, torch.as_tensor(xs),
                            torch.as_tensor(us)))
    np.testing.assert_allclose(cost, float(fx["cost"]), rtol=1e-9)
    xs_re = rollout(lambda x, u: problem_dynamics(problem, x, u),
                    torch.as_tensor(xs[0]), torch.as_tensor(us))
    np.testing.assert_allclose(xs_re.numpy(), xs, rtol=1e-7, atol=1e-8)


def test_fixture_first_order_stationary():
    fx = load("rbd_T1000_converged")
    b = backward_pass(make_rbd_arm_problem(), torch.as_tensor(fx["xs"]),
                      torch.as_tensor(fx["us"]), CONFIG.replace(reg=1e-3))
    cost = float(fx["cost"])
    assert abs(float(b.dV1)) <= 1e-4 * cost, (float(b.dV1), cost)


@pytest.mark.slow
def test_rbd_T500_fixture_parity():
    fx = load("rbd_T500")
    assert not bool(fx["converged"])
    problem = make_rbd_arm_problem(
        reference_kinematics=bool(fx["reference_kinematics"]))
    res = solve(problem, torch.as_tensor(fx["xs0"]),
                torch.as_tensor(fx["us0"]),
                config=ILQRConfig(max_iter=int(fx["iterations"]), tol=0.0),
                device="cpu")
    err = float(np.max(np.abs(res.us.numpy() - fx["us_ref"])))
    assert err < PARITY_BUDGET, err
    np.testing.assert_allclose(float(res.cost), float(fx["cost_ref"]),
                               rtol=1e-8)
