"""The port's per-scenario forward pass (``ilqr_tpu_torch.forward``) against
the JAX package's, float64, CPU.

A batch ``[B, ...]`` through the port's leading axis against ``jax.vmap`` of
the JAX ``forward_pass`` (a vmapped ``lax.while_loop``), on an iterate
where lanes accept at different rungs: each acceptance rule, inactive lanes,
per-lane warm-started first rungs, a reference trajectory, and lanes whose
ladder runs out, which return their LAST TRIED rollout.  Trajectories and
costs rtol 1e-10 / atol 1e-12; flags, alphas and rung counts exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_tpu import backward as jbw
from ilqr_tpu import forward as jfw
from ilqr_tpu.config import ILQRConfig as JaxConfig
from ilqr_tpu.models.two_link import TwoLinkParams as JaxParams
from ilqr_tpu.models.two_link import make_two_link_problem as jax_two_link
from ilqr_tpu.problem import rollout as jax_rollout
from ilqr_tpu.problem import total_cost as jax_total_cost
from ilqr_tpu_torch import forward as tfw
from ilqr_tpu_torch.convert import (config_from_fields, result_to_numpy,
                                    two_link_params_from_fields)
from ilqr_tpu_torch.models.two_link import make_two_link_problem
from tests.torch_parity import assert_close, scenarios, to_torch

RTOL = 1e-10
ATOL = 1e-12
B, T = 6, 16

# Ten times the benchmark's step and wild initial controls: some lanes
# backtrack, so lanes accept at different rungs.
PARAMS = JaxParams(dt=0.1)


def _iterate():
    """The stiff iterate, its gains from the JAX scan backend and its cost,
    as numpy arrays ``[B, ...]``."""

    jp = jax_two_link(PARAMS)
    x0s, us0 = scenarios(B, T, 3, 0.3, 3.0)
    us = jnp.asarray(us0)
    xs = jax.vmap(lambda x0, u: jax_rollout(jp.dynamics, x0, u))(
        jnp.asarray(x0s), us)
    cfg = JaxConfig(reg=1e-2)
    gains = jax.jit(jax.vmap(lambda x, u: jbw.backward_pass(jp, x, u, cfg)))(
        xs, us)
    prev = jax.vmap(lambda x, u: jax_total_cost(jp, x, u))(xs, us)
    return tuple(np.asarray(a) for a in (xs, us) + tuple(gains) + (prev,))


_ITERATE = []


def _cached_iterate():
    if not _ITERATE:
        _ITERATE.append(_iterate())
    return _ITERATE[0]


FLAGS = {
    "default": dict(),
    "exact_ls_delta_x_ref": dict(exact_ls_delta=True),
    "expected_decrease_alpha_init": dict(ls_expected_decrease=True, ls_c=0.4),
    "short_ladder": dict(max_backtracks=1),
}


@pytest.mark.parametrize("flags", sorted(FLAGS))
def test_forward_pass_batched(flags):
    xs, us, duffs, Ks, dV1, dV2, prev = _cached_iterate()
    jp = jax_two_link(PARAMS)
    tp = make_two_link_problem(two_link_params_from_fields(PARAMS))
    jcfg = JaxConfig(**FLAGS[flags])
    tcfg = config_from_fields(jcfg)
    active = np.array([True, True, False, True, True, True])
    alpha_init = (np.array([1.0, 0.5, 1.0, 0.25, 1.0, 0.125])
                  if flags == "expected_decrease_alpha_init" else None)
    x_ref = (0.05 * np.random.default_rng(4).standard_normal((B, T + 1, 4))
             if flags == "exact_ls_delta_x_ref" else None)

    def jax_forward(x, u, d, K, p, a, v1, v2, ai, r):
        return jfw.forward_pass(jp, x, u, d, K, p, r, jcfg, active=a, dV1=v1,
                                dV2=v2, alpha_init=ai)

    in_axes = (0,) * 8 + (None if alpha_init is None else 0,
                          None if x_ref is None else 0)
    ref = jax.jit(jax.vmap(jax_forward, in_axes=in_axes))(
        *map(jnp.asarray, (xs, us, duffs, Ks, prev, active, dV1, dV2)),
        None if alpha_init is None else jnp.asarray(alpha_init),
        None if x_ref is None else jnp.asarray(x_ref))
    out = tfw.forward_pass(
        tp, *map(to_torch, (xs, us, duffs, Ks, prev)),
        None if x_ref is None else to_torch(x_ref), tcfg,
        active=torch.as_tensor(active), dV1=to_torch(dV1),
        dV2=to_torch(dV2),
        alpha_init=None if alpha_init is None else to_torch(alpha_init))

    assert isinstance(out, tfw.ForwardResult)
    got, want = result_to_numpy(out), result_to_numpy(ref)
    for name in ("accepted", "backtracks", "alpha"):
        np.testing.assert_array_equal(got[name], want[name], name)
    for name in ("xs", "us", "cost"):
        assert_close(got[name], want[name], RTOL, ATOL, err_msg=name)
    assert out.backtracks.dtype == torch.int32
    assert out.accepted.dtype == torch.bool

    # The inactive lane: not accepted, no rung, its inputs and an inf cost.
    assert not got["accepted"][2] and got["backtracks"][2] == 0
    np.testing.assert_array_equal(got["us"][2], us[2])
    assert np.isinf(got["cost"][2])
    if flags == "short_ladder":
        # Lanes that ran out of rungs report them all and keep the last
        # tried rollout (at alpha / factor: the carry has already stepped
        # down once more), not the old iterate.
        out_of_rungs = ~got["accepted"] & active
        assert out_of_rungs.any()
        assert (got["backtracks"][out_of_rungs] == 1).all()
        i = int(np.flatnonzero(out_of_rungs)[0])
        assert not np.array_equal(got["us"][i], us[i])
        assert np.isfinite(got["cost"][i])
        last = tfw.closed_loop_rollout(
            tp, *map(to_torch, (xs[i], us[i], duffs[i], Ks[i])),
            got["alpha"][i] / jcfg.alpha_factor)
        assert torch.equal(last[1], out.us[i])
    else:
        assert int(got["backtracks"].max()) >= 1


def test_forward_pass_one_scenario():
    """No leading axis: the JAX function as it is, unbatched."""

    xs, us, duffs, Ks, dV1, dV2, prev = (a[1] for a in _cached_iterate())
    jp = jax_two_link(PARAMS)
    tp = make_two_link_problem(two_link_params_from_fields(PARAMS))
    jcfg = JaxConfig(exact_ls_delta=True)
    ref = jax.jit(lambda *a: jfw.forward_pass(jp, *a, None, jcfg))(
        *map(jnp.asarray, (xs, us, duffs, Ks, prev)))
    out = tfw.forward_pass(tp, *map(to_torch, (xs, us, duffs, Ks, prev)),
                           None, config_from_fields(jcfg))
    got, want = result_to_numpy(out), result_to_numpy(ref)
    assert got["backtracks"].shape == ()
    for name in ("accepted", "backtracks", "alpha"):
        np.testing.assert_array_equal(got[name], want[name], name)
    for name in ("xs", "us", "cost"):
        assert_close(got[name], want[name], RTOL, ATOL, err_msg=name)

    rollout_ref = jfw.closed_loop_rollout(
        jp, *map(jnp.asarray, (xs, us, duffs, Ks)), 0.25)
    rollout = tfw.closed_loop_rollout(
        tp, *map(to_torch, (xs, us, duffs, Ks)), 0.25)
    for o, r in zip(rollout, rollout_ref):
        assert_close(o, r, RTOL, ATOL)
