"""The port's batch-last engine against the JAX package's, float64, CPU.

Module by module (``derivatives_bl``, ``forward_pass_bl``, one
``ilqr_step`` from each of several mid-solve JAX states carried through
``convert.py``) to rtol 1e-10, and the whole ``batched_solve_fused`` under
three flag sets: ``status`` and ``iterations`` identical, ``us`` to rtol
1e-8 / atol 1e-10
(two float64 programs that differ in the order of their sums; the solve
amplifies that through its iterations but the decisions must not flip).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_tpu import batched as jb
from ilqr_tpu.config import ILQRConfig as JaxConfig
from ilqr_tpu.models.two_link import TwoLinkParams as JaxParams
from ilqr_tpu.models.two_link import make_two_link_problem as jax_two_link
from ilqr_tpu.parallel.batching import batch_solve as jax_batch_solve
from ilqr_tpu.step import ilqr_step as jax_ilqr_step
from ilqr_tpu.step import initial_state as jax_initial_state
from ilqr_tpu_torch import batched as tb
from ilqr_tpu_torch.convert import (config_from_fields, result_to_numpy,
                                    step_state_from_numpy,
                                    step_state_to_numpy,
                                    two_link_params_from_fields)
from ilqr_tpu_torch.models.two_link import make_two_link_problem
from ilqr_tpu_torch.parallel.batching import (batch_metrics, batch_solve,
                                              make_batch_solver)
from ilqr_tpu_torch.step import ilqr_step
from tests.torch_parity import (assert_close, jax_iterate_bl, scenarios,
                                to_torch)

RTOL = 1e-10
ATOL = 1e-12

# A stiff variant (ten times the step, wild initial controls): the ladder
# backtracks up to 8 rungs and some lanes hit the iteration cap, which the
# benchmark's gentle scenarios never do at this size.
STIFF = dict(params=JaxParams(dt=0.1), x_noise=0.3, u_noise=3.0)
GENTLE = dict(params=JaxParams(), x_noise=0.1, u_noise=0.0)


def _problems(params):
    return (jax_two_link(params),
            make_two_link_problem(two_link_params_from_fields(params)))


_derivatives_ref = {}


@pytest.mark.parametrize("chunk", [0, 4])
@pytest.mark.parametrize("batch_trailing", [True, False])
@pytest.mark.parametrize("analytic", [True, False])
def test_derivatives_bl(analytic, batch_trailing, chunk):
    B, T = 5, 12
    if analytic not in _derivatives_ref:
        jp = jax_two_link(analytic_cost_derivatives=analytic)
        xs, us = jax_iterate_bl(jp, *scenarios(B, T, 0, u_noise=0.5))
        _derivatives_ref[analytic] = (xs, us, jb.derivatives_bl(
            jp, jnp.asarray(xs), jnp.asarray(us)))
    xs, us, ref = _derivatives_ref[analytic]
    tp = dataclasses.replace(
        make_two_link_problem(analytic_cost_derivatives=analytic),
        batch_trailing=batch_trailing)
    out = tb.derivatives_bl(tp, to_torch(xs), to_torch(us), chunk=chunk)
    assert len(out) == len(ref) == 9
    for o, r in zip(out, ref):
        assert o.is_contiguous()
        assert_close(o, r, RTOL, ATOL)


@pytest.mark.parametrize("batch_trailing", [True, False])
def test_derivatives_bl_keeps_float32(batch_trailing):
    """float32 in, float32 out, on both paths: inside a per-scenario vmap
    torch.func widens ``0-d float32 tensor * Python float`` to float64, which
    the float64 comparisons above cannot see."""

    B, T = 3, 5
    tp = dataclasses.replace(make_two_link_problem(),
                             batch_trailing=batch_trailing)
    x0s, us0 = scenarios(B, T, 8, u_noise=0.5)
    us = to_torch(us0).movedim(0, -1).float()
    xs = tb.rollout_bl(tp, to_torch(x0s.T).float(), us)
    out = tb.derivatives_bl(tp, xs, us)
    assert xs.dtype == torch.float32
    assert all(o.dtype == torch.float32 for o in out)
    ref = tb.derivatives_bl(tp, xs.double(), us.double())
    for o, r in zip(out, ref):
        assert_close(o.double(), r, 1e-5, 1e-6)


def test_rollout_and_costs_bl():
    B, T = 5, 12
    jp, tp = _problems(JaxParams())
    x0s, us0 = scenarios(B, T, 1, u_noise=0.5)
    xs, us = jax_iterate_bl(jp, x0s, us0)
    x_ref = 0.1 * np.random.default_rng(2).standard_normal(xs.shape)
    for prob in (tp, dataclasses.replace(tp, batch_trailing=False)):
        assert_close(tb.rollout_bl(prob, to_torch(x0s.T), to_torch(us)), xs,
                     RTOL)
        for ref_arr in (None, x_ref):
            jr = None if ref_arr is None else jnp.asarray(ref_arr)
            tr = None if ref_arr is None else to_torch(ref_arr)
            steps_ref, final_ref = jb.step_costs_bl(
                jp, jnp.asarray(xs), jnp.asarray(us), jr)
            steps, final = tb.step_costs_bl(prob, to_torch(xs), to_torch(us),
                                            tr)
            assert_close(steps, steps_ref, RTOL)
            assert_close(final, final_ref, RTOL)
            assert_close(
                tb.total_cost_bl(prob, to_torch(xs), to_torch(us), tr),
                jb.total_cost_bl(jp, jnp.asarray(xs), jnp.asarray(us), jr),
                RTOL)


FORWARD_FLAGS = {
    "default": dict(),
    "exact_ls_delta": dict(exact_ls_delta=True),
    "expected_decrease_alpha_init": dict(ls_expected_decrease=True, ls_c=0.4),
}


@pytest.mark.parametrize("flags", sorted(FORWARD_FLAGS))
def test_forward_pass_bl(flags):
    """The ladder on a stiff iterate (several rungs, lanes that accept at
    different depths), with a finite previous cost and inactive lanes."""

    B, T = 6, 16
    jp, tp = _problems(STIFF["params"])
    jcfg = JaxConfig(**FORWARD_FLAGS[flags])
    tcfg = config_from_fields(jcfg)
    x0s, us0 = scenarios(B, T, 3, STIFF["x_noise"], STIFF["u_noise"])
    xs, us = jax_iterate_bl(jp, x0s, us0)
    jxs, jus = jnp.asarray(xs), jnp.asarray(us)
    models = jb.derivatives_bl(jp, jxs, jus)
    duffs, Ks, dv1, dv2 = jb.riccati_bl_scan(*models, 1e-2)
    prev = jb.total_cost_bl(jp, jxs, jus)
    active = np.array([True, True, False, True, True, True])
    use_init = flags == "expected_decrease_alpha_init"
    alpha_init = (np.array([1.0, 0.5, 1.0, 0.25, 1.0, 0.125]) if use_init
                  else None)

    ref = jb.forward_pass_bl(
        jp, jxs, jus, duffs, Ks, prev, None, jcfg, active=jnp.asarray(active),
        dV1=dv1, dV2=dv2,
        alpha_init=None if alpha_init is None else jnp.asarray(alpha_init))
    out = tb.forward_pass_bl(
        tp, to_torch(xs), to_torch(us), to_torch(duffs), to_torch(Ks),
        to_torch(prev), None, tcfg, active=torch.as_tensor(active),
        dV1=to_torch(dv1), dV2=to_torch(dv2),
        alpha_init=None if alpha_init is None else to_torch(alpha_init))

    names = ("xs", "us", "cost", "accepted", "alpha", "backtracks")
    for name, o, r in zip(names, out, ref):
        if name in ("accepted", "backtracks"):
            np.testing.assert_array_equal(o.numpy(), np.asarray(r), name)
        else:
            assert_close(o, r, RTOL, ATOL, err_msg=name)
    assert out[5].dtype == torch.int32 and out[3].dtype == torch.bool
    assert int(out[5].max()) >= 1          # the ladder did backtrack
    assert not bool(out[3][2])             # the inactive lane is not accepted


def _jax_solve_trace(jp, jcfg, x0s, us0, n_steps):
    """States ``s_0 … s_n`` of the JAX engine's first ``n`` iterations and
    the backtracks of each."""

    xs, us = jax_iterate_bl(jp, x0s, us0)
    engine = jb.make_batch_last_engine(jp, None, jcfg)

    @jax.jit
    def run(xs, us):
        states = [jax_initial_state(xs, us, jcfg, lane_shape=(xs.shape[-1],))]
        bts = []
        for _ in range(n_steps):
            nxt, aux = jax_ilqr_step(engine, jcfg, states[-1])
            states.append(nxt)
            bts.append(aux.backtracks)
        return states, bts

    return run(jnp.asarray(xs), jnp.asarray(us))


@pytest.mark.parametrize("flags", ["adaptive_reg_warm_start"])
def test_ilqr_step_from_jax_states(flags):
    """Mid-solve JAX ``StepState``s cross through ``convert.py``; from each,
    one iteration of the port equals the JAX engine's next state.  The
    stiff scenario makes the ladder backtrack and the regularization move,
    and stepping from the JAX state each time keeps its chaos from
    compounding rounding over the iterations."""

    B, T, n_steps = 6, 16, 4
    kw = dict(tol_grad=1e-10, tol_grad_rel=1e-6)
    if flags != "fixed_reg":
        kw.update(adaptive_reg=True, reg_backtrack_trigger=1,
                  ls_alpha_warm_start=True)
    jcfg = JaxConfig(**kw)
    tcfg = config_from_fields(jcfg)
    jp, tp = _problems(STIFF["params"])
    x0s, us0 = scenarios(B, T, 4, STIFF["x_noise"], STIFF["u_noise"])
    states, bts = _jax_solve_trace(jp, jcfg, x0s, us0, n_steps)
    engine = tb.make_batch_last_engine(tp, None, tcfg)

    for i in range(n_steps):
        state, ref_next = states[i], states[i + 1]
        tstate = step_state_from_numpy(
            {k: np.asarray(v) for k, v in state._asdict().items()},
            device="cpu")
        assert tstate.status.dtype == tstate.iteration.dtype == torch.int32
        back = step_state_to_numpy(tstate)          # the state round-trips
        for k, v in state._asdict().items():
            np.testing.assert_array_equal(back[k], np.asarray(v), k)
            assert back[k].dtype == np.asarray(v).dtype, k

        nxt, aux = ilqr_step(engine, tcfg, tstate)
        for k, r in ref_next._asdict().items():
            o = getattr(nxt, k)
            if k in ("iteration", "status"):
                assert o.dtype == torch.int32
                np.testing.assert_array_equal(o.numpy(), np.asarray(r), k)
            else:
                assert o.dtype == torch.float64
                assert_close(o, r, RTOL, ATOL, err_msg=f"step {i}: {k}")
        np.testing.assert_array_equal(aux.backtracks.numpy(),
                                      np.asarray(bts[i]))

    assert max(int(np.asarray(b).max()) for b in bts) >= 2
    if flags != "fixed_reg":
        regs = np.stack([np.asarray(s.reg) for s in states])
        moves = np.diff(regs, axis=0)   # the schedule went both ways
        assert (moves > 0).any() and (moves < 0).any()


# Ten times the benchmark's step and random initial controls, short of the
# stiff scenario's chaos: 6-10 iterations a lane, and a whole solve that
# does not amplify rounding beyond the tolerance.
MODERATE = dict(params=JaxParams(dt=0.1), x_noise=0.3, u_noise=1.5)

SOLVE_FLAGS = {
    # bench.py's default cell, through the kernel's path on both sides: the
    # Pallas kernel in interpret mode, the CUDA kernel's plain version.
    "headline": (GENTLE, dict(max_iter=20, tol=1e-5, tol_grad=1e-10,
                              tol_grad_rel=1e-6, reg=1e-2,
                              backward_backend="pallas")),
    # bench.py's strict cell: the reference's own convergence rule.
    # It also carries a reference trajectory: x_refs offsets the running
    # cost only (the local models do not see it).
    "strict": (GENTLE, dict(max_iter=20, tol=1e-6, tol_grad=0.0,
                            tol_grad_rel=0.0, exact_ls_delta=True)),
    # max_iter cuts the slowest lanes: MAX_ITER beside CONVERGED.
    "adaptive_reg": (MODERATE, dict(max_iter=8, adaptive_reg=True,
                                    reg_backtrack_trigger=1,
                                    ls_alpha_warm_start=True)),
}


@pytest.mark.parametrize("flags", sorted(SOLVE_FLAGS))
def test_batched_solve_fused(flags):
    scen, kw = SOLVE_FLAGS[flags]
    B, T = 6, 20
    jcfg = JaxConfig(**kw)
    jp, tp = _problems(scen["params"])
    x0s, us0 = scenarios(B, T, 5, scen["x_noise"], scen["u_noise"])

    if flags == "strict":
        x_refs = 0.05 * np.random.default_rng(7).standard_normal((B, T + 1, 4))
        ref = jax_batch_solve(jp, jnp.asarray(x0s), jnp.asarray(us0),
                              x_refs=jnp.asarray(x_refs), config=jcfg,
                              engine="fused")
        res = batch_solve(tp, to_torch(x0s), to_torch(us0),
                          x_refs=to_torch(x_refs),
                          config=config_from_fields(jcfg), device="cpu")
        no_ref = batch_solve(tp, to_torch(x0s), to_torch(us0),
                             config=config_from_fields(jcfg), device="cpu")
        assert not torch.allclose(no_ref.cost, res.cost)
    else:
        ref = jax_batch_solve(jp, jnp.asarray(x0s), jnp.asarray(us0),
                              config=jcfg, engine="fused")
        solve_fn = make_batch_solver(tp, config_from_fields(jcfg),
                                     engine="fused", device="cpu")
        res = solve_fn(to_torch(x0s), to_torch(us0))
    out = result_to_numpy(res)

    np.testing.assert_array_equal(out["status"], np.asarray(ref.status))
    np.testing.assert_array_equal(out["iterations"],
                                  np.asarray(ref.iterations))
    assert out["status"].dtype == out["iterations"].dtype == np.int32
    assert_close(out["us"], ref.us, 1e-8, 1e-10)
    assert_close(out["xs"], ref.xs, 1e-8, 1e-10)
    assert_close(out["cost"], ref.cost, 1e-8)
    assert_close(out["reg"], ref.reg, 1e-12)
    assert_close(out["alpha"], ref.alpha, 1e-12)
    if scen is MODERATE:
        assert out["iterations"].max() == 8
        assert (out["status"] == 2).any() and (out["status"] == 1).any()

    metrics = batch_metrics(res)
    assert int(metrics["n_converged"]) == int((out["status"] == 1).sum())
    assert_close(metrics["mean_cost"], np.mean(out["cost"]), 1e-12)
