"""The port's parallel-alpha ladder against the JAX package's sequential
ladder, float64, CPU.

``tests/test_torch_parallel_alpha.py`` holds the parallel ladder equal to
the port's own sequential one in the four acceptance modes, and against
JAX in ``ratio_exact``.  This file holds it against the JAX package's
``batched_solve_fused`` in the other three modes, and in a solve with
``reg=1e3`` and ``max_backtracks=11`` (no multiple of R), whose early
ladders run deep: ``status``, ``iterations`` and ``alpha`` identical, ``us``
to rtol 1e-10.  One JAX compile a case, shared by both R.  A whole solve
shows only its last pass's alpha; ``tests/test_torch_parallel_alpha_ladder.py``
holds the exhaustion bookkeeping one ladder at a time.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

from ilqr_tpu.batched import batched_solve_fused as jax_fused
from ilqr_tpu.config import ILQRConfig as JaxConfig
from ilqr_tpu.models.two_link import make_two_link_problem as jax_two_link
from ilqr_tpu_torch.batched import batched_solve_fused
from ilqr_tpu_torch.convert import config_from_fields
from tests.test_torch_parallel_alpha import BASE, MODES, setup
from tests.torch_parity import assert_close, jit_once

CASES = {
    "plain": (dict(BASE, **MODES["plain"]), {}),
    "exact": (dict(BASE, **MODES["exact"]), {}),
    "ratio": (dict(BASE, **MODES["ratio"]), {}),
    "exhaustion": (dict(max_iter=6, tol=1e-8, tol_grad=0.0, tol_grad_rel=0.0,
                        reg=1e3, max_backtracks=11), dict(B=4, T=20)),
}


@functools.lru_cache(maxsize=None)
def jax_reference(case):
    kw, shape = CASES[case]
    _, xs0, us0 = setup(**shape)
    return jit_once(lambda a, b: jax_fused(jax_two_link(), a, b,
                                           config=JaxConfig(**kw)),
                    jnp.asarray(xs0.numpy()), jnp.asarray(us0.numpy()))


def check_against_jax(case, R):
    kw, shape = CASES[case]
    tp, xs0, us0 = setup(**shape)
    par = batched_solve_fused(
        tp, xs0, us0,
        config=config_from_fields(dict(kw, parallel_alpha_block=R)),
        device="cpu")
    ref = jax_reference(case)
    np.testing.assert_array_equal(par.status.numpy(), np.asarray(ref.status))
    np.testing.assert_array_equal(par.iterations.numpy(),
                                  np.asarray(ref.iterations))
    np.testing.assert_array_equal(par.alpha.numpy(), np.asarray(ref.alpha))
    assert_close(par.us, ref.us, 1e-10)
    return par


@pytest.mark.parametrize("R", [4, 8])
@pytest.mark.parametrize("mode", ["exact", "plain", "ratio"])
def test_parallel_alpha_matches_jax(mode, R):
    check_against_jax(mode, R)


@pytest.mark.parametrize("R", [3, 4])
def test_deep_backtracks_and_exhaustion_match_jax(R):
    check_against_jax("exhaustion", R)
