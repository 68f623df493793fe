"""The parallel-alpha ladder of the port's fused engine
(``parallel_alpha_block``), float64, CPU.

Evaluating R rungs of the ladder as extra lanes of one rollout must make
EXACTLY the decisions of the sequential ladder: for the four acceptance
modes of ``tests/test_parallel_alpha.py`` (any decrease, ``exact_ls_delta``,
``ls_expected_decrease``, both) and R in {4, 8}, the port's parallel solve
equals its sequential solve in every field; in the mode ``ratio_exact``
(both flags of the acceptance test on) it also agrees with the JAX
package's sequential solve (``status``, ``iterations`` and ``alpha``
identical, ``us`` to rtol 1e-10); ``tests/test_torch_parallel_alpha_jax.py``
holds it against JAX in the other three modes and the deep-ladder solve,
and ``tests/test_torch_parallel_alpha_ladder.py`` one ladder at a time
where ladders run out.  Ladders that run deeper than one block, and
ladders that run out, are checked here against the port's sequential
ladder; ``x_ref`` goes with its lanes into the expanded batch.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_tpu.batched import batched_solve_fused as jax_fused
from ilqr_tpu.config import ILQRConfig as JaxConfig
from ilqr_tpu.models.two_link import make_two_link_problem as jax_two_link
from ilqr_tpu_torch.batched import batched_solve_fused, rollout_bl
from ilqr_tpu_torch.convert import config_from_fields
from ilqr_tpu_torch.models.two_link import make_two_link_problem
from tests.torch_parity import NOMINAL, assert_close, jit_once, to_torch

torch.set_num_threads(1)

MODES = {
    "plain": {},
    "exact": dict(exact_ls_delta=True),
    "ratio": dict(ls_expected_decrease=True, ls_c=0.3),
    "ratio_exact": dict(exact_ls_delta=True, ls_expected_decrease=True,
                        ls_c=0.3),
}
JAX_MODES = ("ratio_exact",)
BASE = dict(max_iter=20, tol=1e-6, tol_grad=0.0, tol_grad_rel=0.0,
            adaptive_reg=True, reg_backtrack_trigger=1)


def setup(B=5, T=24, seed=0):
    rng = np.random.default_rng(seed)
    x0s = NOMINAL + 0.2 * rng.standard_normal((B, 4))
    us0 = np.zeros((B, T, 2))
    tp = make_two_link_problem()
    xs0 = rollout_bl(tp, to_torch(x0s.T), to_torch(us0).movedim(0, -1))
    return tp, xs0.movedim(-1, 0).contiguous(), to_torch(us0)


def assert_equal(a, b):
    for name, x, y in zip(a._fields, a, b):
        assert torch.equal(x, y), name


@functools.lru_cache(maxsize=None)
def sequential(mode):
    """The port's and the JAX package's sequential solves of one mode."""

    tp, xs0, us0 = setup()
    kw = dict(BASE, **MODES[mode])
    port = batched_solve_fused(tp, xs0, us0,
                               config=config_from_fields(kw), device="cpu")
    if mode not in JAX_MODES:
        return port, None
    ref = jit_once(lambda a, b: jax_fused(jax_two_link(), a, b,
                                          config=JaxConfig(**kw)),
                   jnp.asarray(xs0.numpy()), jnp.asarray(us0.numpy()))
    return port, ref


@pytest.mark.parametrize("R", [4, 8])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_parallel_alpha_matches_sequential(mode, R):
    tp, xs0, us0 = setup()
    kw = dict(BASE, **MODES[mode])
    par = batched_solve_fused(
        tp, xs0, us0, config=config_from_fields(dict(kw,
                                                     parallel_alpha_block=R)),
        device="cpu")
    seq, ref = sequential(mode)
    assert_equal(par, seq)
    if ref is None:
        return
    np.testing.assert_array_equal(par.status.numpy(), np.asarray(ref.status))
    np.testing.assert_array_equal(par.iterations.numpy(),
                                  np.asarray(ref.iterations))
    np.testing.assert_array_equal(par.alpha.numpy(), np.asarray(ref.alpha))
    assert_close(par.us, ref.us, 1e-10)


@pytest.mark.parametrize("R", [3, 4])
def test_deep_backtracks_and_exhaustion(R):
    """A large reg makes early steps poor: ladders deeper than one block,
    and ladders that run out (``max_backtracks=11`` is no multiple of R)."""

    tp, xs0, us0 = setup(B=4, T=20)
    kw = dict(max_iter=6, tol=1e-8, tol_grad=0.0, tol_grad_rel=0.0,
              reg=1e3, max_backtracks=11)
    seq = batched_solve_fused(tp, xs0, us0, config=config_from_fields(kw),
                              device="cpu")
    par = batched_solve_fused(
        tp, xs0, us0,
        config=config_from_fields(dict(kw, parallel_alpha_block=R)),
        device="cpu")
    assert_equal(par, seq)


def test_x_ref_goes_with_its_lanes():
    tp, xs0, us0 = setup(B=3, T=12)
    x_ref = to_torch(0.05 * np.random.default_rng(1).standard_normal(
        (3, 13, 4)))
    kw = dict(BASE, max_iter=8)
    seq = batched_solve_fused(tp, xs0, us0, x_ref=x_ref,
                              config=config_from_fields(kw), device="cpu")
    par = batched_solve_fused(
        tp, xs0, us0, x_ref=x_ref,
        config=config_from_fields(dict(kw, parallel_alpha_block=4)),
        device="cpu")
    assert_equal(par, seq)
