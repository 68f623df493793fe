"""``batch_solve(engine="vmap")`` of the port against the JAX package's,
float64, CPU: the per-scenario solver on a leading batch axis against
``jax.vmap`` of the JAX ``solve``, scan backend.  ``status`` and
``iterations`` exactly, ``us`` to rtol 1e-9 / atol 1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ilqr_tpu.config import ILQRConfig as JaxConfig
from ilqr_tpu.parallel.batching import batch_solve as jax_batch_solve
from ilqr_tpu_torch.config import Status
from ilqr_tpu_torch.convert import config_from_fields, result_to_numpy
from ilqr_tpu_torch.parallel.batching import batch_solve
from tests.test_torch_solver import GENTLE, MODERATE, _check_result, _problems
from tests.torch_parity import scenarios, to_torch


VMAP = {
    # max_iter cuts the slowest lanes while the others have converged:
    # their iteration counts stay frozen at the cap.
    "max_iter_cut": (MODERATE, dict(max_iter=8, adaptive_reg=True,
                                    reg_backtrack_trigger=1,
                                    ls_alpha_warm_start=True)),
    # The reference's strict rule with a per-lane reference trajectory.
    "strict_x_refs": (GENTLE, dict(max_iter=20, tol=1e-6, tol_grad=0.0,
                                   tol_grad_rel=0.0, exact_ls_delta=True)),
    # The per-scenario engine's own flags (the fused engines of both
    # packages do not take them, ROADMAP.md C1).
    "ddp_reg_in_value": (MODERATE, dict(max_iter=12, ddp=True,
                                        reg_in_value=True)),
}


@pytest.mark.parametrize("case", sorted(VMAP))
def test_batch_solve_vmap_against_jax(case):
    scen, kw = VMAP[case]
    B, T = 5, 20
    jcfg = JaxConfig(**kw)
    jp, tp = _problems(scen["params"])
    x0s, us0 = scenarios(B, T, 5, scen["x_noise"], scen["u_noise"])
    x_refs = (0.05 * np.random.default_rng(7).standard_normal((B, T + 1, 4))
              if case == "strict_x_refs" else None)
    ref = jax.jit(lambda a, b, r: jax_batch_solve(
        jp, a, b, x_refs=r, config=jcfg, engine="vmap"))(
            jnp.asarray(x0s), jnp.asarray(us0),
            None if x_refs is None else jnp.asarray(x_refs))
    out = batch_solve(tp, to_torch(x0s), to_torch(us0),
                      x_refs=None if x_refs is None else to_torch(x_refs),
                      config=config_from_fields(jcfg), engine="vmap",
                      device="cpu")
    assert out.us.shape == (B, T, 2) and out.status.shape == (B,)
    _check_result(out, ref)
    status = result_to_numpy(out)["status"]
    if case == "max_iter_cut":
        iters = result_to_numpy(out)["iterations"]
        cut = status == int(Status.MAX_ITER)
        assert cut.any() and (status == int(Status.CONVERGED)).any()
        assert (iters[cut] == 8).all() and (iters[~cut] <= 8).all()
        assert (iters[~cut] < 8).any()
