"""The port's receding-horizon MPC (``ilqr_tpu_torch.parallel.mpc``) against
the JAX package's, float64, CPU: horizon 20, 5 control steps.

``mpc_run`` of one scenario against the jitted JAX ``mpc_run`` (a
``lax.scan`` over replans); ``batch_mpc_run`` on a leading batch axis
against ``jax.vmap`` of it; the batch's row 0 against the port's single run.
Statuses and iterations exactly; states, controls and planned costs rtol
1e-9 / atol 1e-10 (two float64 programs summing in other orders, over five
warm-started replans).  The stationarity test ends each replan before its
any-decrease ladder reaches rounding noise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_tpu.config import ILQRConfig as JaxConfig
from ilqr_tpu.models.two_link import TwoLinkParams as JaxParams
from ilqr_tpu.models.two_link import make_two_link_problem as jax_two_link
from ilqr_tpu.parallel import mpc as jmpc
from ilqr_tpu_torch.config import Status
from ilqr_tpu_torch.convert import (config_from_fields, result_to_numpy,
                                    two_link_params_from_fields)
from ilqr_tpu_torch.models.two_link import make_two_link_problem
from ilqr_tpu_torch.ops import riccati_dispatch
from ilqr_tpu_torch.ops.cuda_riccati import riccati_scan_cuda_batched
from ilqr_tpu_torch.parallel import (MPCResult, batch_mpc_run,
                                     make_mpc_runner, mpc_run)
from tests.torch_parity import assert_close, to_torch

H, STEPS = 20, 5
RTOL, ATOL = 1e-9, 1e-10
X0S = np.array([[0.1, -0.1, 0.0, 0.0], [0.3, 0.2, 0.0, 0.0],
                [0.5, 0.9, 0.3, -0.2]])
CONFIG = dict(max_iter=15, tol=1e-8, tol_grad=1e-10, tol_grad_rel=1e-6)


def _check(out, ref):
    assert isinstance(out, MPCResult)
    got, want = result_to_numpy(out), result_to_numpy(ref)
    np.testing.assert_array_equal(got["statuses"], want["statuses"])
    np.testing.assert_array_equal(got["iterations"], want["iterations"])
    for name in ("xs", "us", "costs"):
        assert_close(got[name], want[name], RTOL, ATOL, err_msg=name)


# Each case: config fields, the model's and the plant's parameters, and the
# scale of a random initial plan.  "ls_failed_fallback": with one rung, ten
# times the step and a wild initial plan every replan ends LINESEARCH_FAILED,
# so each applied control comes from the warm start.  (The batch test below
# runs the plant that is the model.)
CASES = {
    "plant_mismatch": (dict(), JaxParams(), JaxParams(m1=1.2), 0.0),
    "ls_failed_fallback": (dict(max_backtracks=1), JaxParams(dt=0.1), None,
                           4.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_mpc_run_against_jax(case):
    kw, params, plant_params, u_scale = CASES[case]
    jcfg = JaxConfig(**CONFIG, **kw)
    jp = jax_two_link(params)
    tp = make_two_link_problem(two_link_params_from_fields(params))
    jplant = tplant = None
    if plant_params is not None:
        jplant = jax_two_link(plant_params).dynamics
        tplant = make_two_link_problem(
            two_link_params_from_fields(plant_params)).dynamics
    x0 = X0S[2]
    u_init = u_scale * np.random.default_rng(2).standard_normal((H, 2))
    ref = jax.jit(lambda x, u: jmpc.mpc_run(jp, x, H, STEPS, jcfg,
                                            plant_dynamics=jplant,
                                            u_init=u))(
        jnp.asarray(x0), jnp.asarray(u_init))
    out = mpc_run(tp, to_torch(x0), H, STEPS, config_from_fields(jcfg),
                  plant_dynamics=tplant, u_init=to_torch(u_init),
                  device="cpu")
    assert out.xs.shape == (STEPS + 1, 4) and out.statuses.shape == (STEPS,)
    _check(out, ref)
    statuses = result_to_numpy(out)["statuses"]
    if case == "ls_failed_fallback":
        assert (statuses == int(Status.LINESEARCH_FAILED)).all()
        # The warm start shifts by one step a replan: the plan held.
        assert_close(out.us, u_init[:STEPS], 0.0, 0.0)
    else:
        assert (statuses == int(Status.CONVERGED)).all()


class _CountBatched:
    def __init__(self):
        self.calls = 0

    def __call__(self, *args, **kw):
        self.calls += 1
        return riccati_scan_cuda_batched(*args, **kw)


_batch_ref = []


@pytest.mark.parametrize("backend", ["scan", "pallas"])
def test_batch_mpc_run_against_jax(backend, monkeypatch):
    """The JAX reference runs the scan backend; under ``"pallas"`` every
    iteration of every replan of the port's batch goes through the
    kernel's batch-first entry (its plain version here)."""

    jcfg = JaxConfig(**CONFIG)
    tcfg = config_from_fields(jcfg).replace(backward_backend=backend)
    jp, tp = jax_two_link(), make_two_link_problem()
    if not _batch_ref:
        # One JAX reference, shared by both backends.
        _batch_ref.append(jax.jit(
            lambda x: jmpc.batch_mpc_run(jp, x, H, STEPS, jcfg))(
                jnp.asarray(X0S)))
    ref = _batch_ref[0]
    counter = _CountBatched()
    monkeypatch.setattr(riccati_dispatch, "riccati_scan_cuda_batched",
                        counter)
    out = batch_mpc_run(tp, to_torch(X0S), H, STEPS, tcfg, device="cpu")
    assert out.us.shape == (3, STEPS, 2)
    _check(out, ref)
    passes = int(out.iterations.max(dim=0).values.sum())
    assert counter.calls == (passes if backend == "pallas" else 0)

    single = make_mpc_runner(tp, H, STEPS, tcfg, device="cpu")(
        to_torch(X0S[0]))
    torch.testing.assert_close(out.us[0], single.us, rtol=0, atol=1e-10)
    assert torch.equal(out.statuses[0], single.statuses)
    assert torch.equal(out.iterations[0], single.iterations)
