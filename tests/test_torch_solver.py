"""The port's per-scenario solver (``solve``, ``make_solver``, ``fit``)
against the JAX package's, float64, CPU; ``solve`` against the NumPy
oracle's golden trajectory; and the port's ``engine="vmap"`` against its
``engine="fused"``.  (``batch_solve(engine="vmap")`` against the JAX
package's is in ``tests/test_torch_vmap.py``: its JAX programs take most of
a minute to build.)

Whole solves agree in ``status`` and ``iterations`` exactly and in ``us`` to
rtol 1e-9 / atol 1e-10 (two float64 programs that sum in other orders; the
scenarios converge in a few iterations, so the solve does not amplify that,
``ROADMAP.md`` C6).  The golden fixture is held as the JAX package's
``tests/test_fixtures.py`` holds it: ``|u - u_ref|_inf < 1e-6``, the same
iteration count, cost to rtol 1e-9.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_tpu.config import ILQRConfig as JaxConfig
from ilqr_tpu.models.two_link import TwoLinkParams as JaxParams
from ilqr_tpu.models.two_link import make_two_link_problem as jax_two_link
from ilqr_tpu.problem import rollout as jax_rollout
from ilqr_tpu.solver import solve as jax_solve
from ilqr_tpu_torch.config import ILQRConfig, Status
from ilqr_tpu_torch.convert import (config_from_fields, result_to_numpy,
                                    two_link_params_from_fields)
from ilqr_tpu_torch.models.two_link import make_two_link_problem
from ilqr_tpu_torch.parallel.batching import batch_solve, make_batch_solver
from ilqr_tpu_torch.solver import SolverResult, fit, make_solver, solve
from tests.torch_parity import assert_close, scenarios, to_torch

FIXTURE_DIR = os.path.join(os.path.dirname(__file__), "fixtures")
US_RTOL, US_ATOL = 1e-9, 1e-10

# Ten times the benchmark's step and random initial controls: 6-10
# iterations a lane, and max_iter=8 cuts the slowest lanes while the others
# have converged.
MODERATE = dict(params=JaxParams(dt=0.1), x_noise=0.3, u_noise=1.5)
GENTLE = dict(params=JaxParams(), x_noise=0.1, u_noise=0.0)


def _problems(params):
    return (jax_two_link(params),
            make_two_link_problem(two_link_params_from_fields(params)))


def _check_result(out, ref, cost_rtol=1e-9):
    got = result_to_numpy(out)
    want = result_to_numpy(ref)
    np.testing.assert_array_equal(got["status"], want["status"])
    np.testing.assert_array_equal(got["iterations"], want["iterations"])
    assert got["status"].dtype == got["iterations"].dtype == np.int32
    assert_close(got["us"], want["us"], US_RTOL, US_ATOL, err_msg="us")
    assert_close(got["xs"], want["xs"], US_RTOL, US_ATOL, err_msg="xs")
    assert_close(got["cost"], want["cost"], cost_rtol, err_msg="cost")
    for name in ("reg", "alpha", "du_sq"):
        assert_close(got[name], want[name], 1e-6, 1e-12, err_msg=name)


def test_solve_make_solver_and_fit_against_jax():
    """One scenario with a reference trajectory (the running cost is
    offset by it, the backward pass quadratizes the raw cost): ``solve``,
    ``make_solver(with_ref=True)`` and ``fit(x_traj=...)`` all equal the
    JAX ``solve``.  The stationarity test ends the solve (in 4 iterations)
    before the any-decrease ladder reaches rounding noise, where the last
    accepted ``alpha`` of two float64 programs is no longer the same rung."""

    T = 30
    jp, tp = _problems(GENTLE["params"])
    x0s, us0 = scenarios(1, T, 11, x_noise=0.2, u_noise=0.5)
    xs0 = np.asarray(jax_rollout(jp.dynamics, jnp.asarray(x0s[0]),
                                 jnp.asarray(us0[0])))
    x_ref = 0.05 * np.random.default_rng(12).standard_normal((T + 1, 4))
    jcfg = JaxConfig(max_iter=40, tol=1e-6, tol_grad=1e-10, tol_grad_rel=1e-6)
    ref = jax.jit(lambda a, b, r: jax_solve(jp, a, b, r, jcfg))(
        jnp.asarray(xs0), jnp.asarray(us0[0]), jnp.asarray(x_ref))
    assert int(ref.status) == int(Status.CONVERGED)
    cfg = config_from_fields(jcfg)

    out = solve(tp, to_torch(xs0), to_torch(us0[0]), to_torch(x_ref), cfg,
                device="cpu")
    assert isinstance(out, SolverResult) and out.us.shape == (T, 2)
    assert out.status.shape == () and bool(out.converged)
    _check_result(out, ref)
    solve_fn = make_solver(tp, cfg, with_ref=True, device="cpu")
    _check_result(solve_fn(to_torch(xs0), to_torch(us0[0]),
                           to_torch(x_ref)), ref)

    xs, us = fit(xs0, us0[0], tp.dynamics, tp.cost, tp.final_cost,
                 x_traj=x_ref, max_iter=40, tol=1e-6, config=cfg,
                 device="cpu")
    assert_close(us, ref.us, US_RTOL, US_ATOL)
    assert_close(xs, ref.xs, US_RTOL, US_ATOL)
    no_ref = solve(tp, to_torch(xs0), to_torch(us0[0]), None, cfg,
                   device="cpu")
    assert not torch.allclose(no_ref.us, out.us)


def _load(name):
    path = os.path.join(FIXTURE_DIR, f"{name}.npz")
    if not os.path.exists(path):
        pytest.skip(f"fixture {name} not generated "
                    "(run scripts/make_fixtures.py)")
    return np.load(path)


def _solve_like_fixture(fx):
    """The port's ``solve`` under the fixture's stopping rule
    (``tests/test_fixtures.py:36-50``)."""

    iters = int(fx["iterations"])
    if bool(fx["converged"]):
        config = ILQRConfig(max_iter=iters + 50, tol=float(fx["tol"]))
    else:
        config = ILQRConfig(max_iter=iters, tol=0.0)
    return solve(make_two_link_problem(), to_torch(fx["xs0"]),
                 to_torch(fx["us0"]), config=config, device="cpu")


def _check_fixture(fx, result):
    err = float(np.max(np.abs(result.us.numpy() - fx["us_ref"])))
    assert err < 1e-6, err
    if bool(fx["converged"]):
        assert int(result.iterations) == int(fx["iterations"])
    np.testing.assert_allclose(float(result.cost), float(fx["cost_ref"]),
                               rtol=1e-9)


def test_two_link_T100_fixture():
    fx = _load("two_link_T100")
    _check_fixture(fx, _solve_like_fixture(fx))


@pytest.mark.slow
def test_two_link_T900_fixture():
    fx = _load("two_link_T900")
    _check_fixture(fx, _solve_like_fixture(fx))


@pytest.mark.parametrize("backend", ["scan", "pallas"])
def test_vmap_engine_equals_fused_engine(backend):
    """The port's two engines on the same batch: same decisions, ``us`` to
    rounding; the ``"pallas"`` backend runs the kernel's batch-first entry
    under ``"vmap"`` and its batch-last entry under ``"fused"`` (both their
    plain versions here).  Float32 stays float32 through the vmap engine."""

    B, T = 6, 20
    _, tp = _problems(MODERATE["params"])
    x0s, us0 = scenarios(B, T, 9, MODERATE["x_noise"], MODERATE["u_noise"])
    cfg = ILQRConfig(max_iter=10, tol=1e-5, tol_grad=1e-10,
                     tol_grad_rel=1e-6, backward_backend=backend)
    fused = batch_solve(tp, to_torch(x0s), to_torch(us0), config=cfg,
                        engine="fused", device="cpu")
    vmap = make_batch_solver(tp, cfg, engine="vmap", device="cpu")(
        to_torch(x0s), to_torch(us0))
    assert torch.equal(vmap.status, fused.status)
    assert torch.equal(vmap.iterations, fused.iterations)
    for name in ("us", "xs", "cost", "reg", "alpha"):
        assert_close(getattr(vmap, name), getattr(fused, name), 1e-10, 1e-12,
                     err_msg=name)

    v32 = batch_solve(tp, to_torch(x0s).float(), to_torch(us0).float(),
                      config=cfg, engine="vmap", device="cpu")
    for name in ("xs", "us", "cost", "reg", "alpha", "du_sq"):
        assert getattr(v32, name).dtype == torch.float32, name
    assert v32.status.dtype == v32.iterations.dtype == torch.int32
    assert bool(torch.isfinite(v32.cost).all())
