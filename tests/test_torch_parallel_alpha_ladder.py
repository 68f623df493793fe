"""The exhaustion bookkeeping of the port's parallel-alpha ladder against
the JAX package's sequential ladder, one ladder at a time, float64, CPU.

A whole solve shows only its last pass's alpha, so
``forward_pass_bl_parallel`` is held against the JAX ``forward_pass_bl`` on
one set of gains: lanes whose step is scaled so that they accept past the
first block, and a lane whose step is reversed so that its ladder runs out
(``max_backtracks=11``, no multiple of R).  In each acceptance mode and for
R in {3, 4}: ``accepted``, ``alpha`` and ``backtracks`` identical — the
alpha of a lane that ran out is the one after its last rejected rung —
``xs``, ``us`` and ``cost`` to rtol 1e-10.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

from ilqr_tpu.batched import forward_pass_bl as jax_ladder
from ilqr_tpu.config import ILQRConfig as JaxConfig
from ilqr_tpu.models.two_link import make_two_link_problem as jax_two_link
from ilqr_tpu_torch.batched import (derivatives_bl, forward_pass_bl_parallel,
                                    riccati_bl_scan, total_cost_bl)
from ilqr_tpu_torch.convert import config_from_fields
from tests.test_torch_parallel_alpha import MODES, setup
from tests.torch_parity import assert_close, jit_once, to_torch


@functools.lru_cache(maxsize=None)
def ladder_inputs():
    """One pass's gains on 4 lanes, batch-last; lane 1's and lane 2's
    steps scaled by 2^6 and 2^9 (their full step is rung 6 and rung 9),
    lane 3's reversed (uphill at every rung)."""

    tp, xs0, us0 = setup(B=4, T=20)
    xs, us = xs0.movedim(0, -1), us0.movedim(0, -1)
    duffs, Ks, dV1, dV2 = riccati_bl_scan(*derivatives_bl(tp, xs, us),
                                          reg=1.0)
    scale = to_torch([1.0, 2.0 ** 6, 2.0 ** 9, -1.0])
    prev_cost = total_cost_bl(tp, xs, us)
    return (tp, xs, us, duffs * scale, Ks, prev_cost, dV1 * scale,
            dV2 * scale * scale)


@functools.lru_cache(maxsize=None)
def jax_ladder_reference(mode):
    _, *arrays = ladder_inputs()
    cfg = JaxConfig(max_backtracks=11, **MODES[mode])
    xs, us, duffs, Ks, prev_cost, dV1, dV2 = (jnp.asarray(a.numpy())
                                              for a in arrays)
    return jit_once(lambda *a: jax_ladder(jax_two_link(), *a[:5], config=cfg,
                                          dV1=a[5], dV2=a[6]),
                    xs, us, duffs, Ks, prev_cost, dV1, dV2)


@pytest.mark.parametrize("R", [3, 4])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_ladder_exhaustion_matches_jax(mode, R):
    tp, xs, us, duffs, Ks, prev_cost, dV1, dV2 = ladder_inputs()
    cfg = config_from_fields(dict(MODES[mode], max_backtracks=11,
                                  parallel_alpha_block=R))
    out = forward_pass_bl_parallel(tp, xs, us, duffs, Ks, prev_cost,
                                   config=cfg, dV1=dV1, dV2=dV2)
    ref = jax_ladder_reference(mode)
    names = ("xs", "us", "cost", "accepted", "alpha", "backtracks")
    for name, a, b in zip(names[3:], out[3:], ref[3:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)
    for name, a, b in zip(names[:3], out[:3], ref[:3]):
        assert_close(a, b, 1e-10, err_msg=name)
    accepted, bts = out[3], out[5]
    # The case reaches what it is for: a ladder past the first block, and
    # one that runs out.
    assert int(bts[accepted].max()) >= R
    assert not bool(accepted.all())
    assert int(bts.max()) == 11
