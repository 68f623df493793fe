"""The port's iteration trace (``utils.metrics.solve_with_trace``) and
profiling hooks (``utils.profiling``), float64, CPU.

* every row of the trace against the JAX package's ``solve_with_trace`` on
  the same scenario (the integer columns and ``valid`` identical, the rest
  to rtol 1e-9), its result against the JAX result and against the port's
  ``solve``; a batch on a leading axis gives a trace per scenario;
* ``PhaseTimer`` accumulates and summarizes, ``annotate`` names a range that
  ``device_trace`` records in the Chrome trace it writes.
"""

import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ilqr_tpu.config import ILQRConfig as JaxConfig
from ilqr_tpu.models.two_link import make_two_link_problem as jax_two_link
from ilqr_tpu.problem import rollout as jax_rollout
from ilqr_tpu.utils.metrics import solve_with_trace as jax_trace
from ilqr_tpu_torch.convert import config_from_fields
from ilqr_tpu_torch.models.two_link import make_two_link_problem
from ilqr_tpu_torch.problem import problem_dynamics, rollout
from ilqr_tpu_torch.solver import solve
from ilqr_tpu_torch.utils.metrics import IterationTrace, solve_with_trace
from ilqr_tpu_torch.utils.profiling import PhaseTimer, annotate, device_trace
from tests.torch_parity import NOMINAL, assert_close, to_torch

torch.set_num_threads(1)

T = 20
FLAGS = dict(max_iter=12, tol=1e-6, tol_grad=1e-10, tol_grad_rel=1e-6)


def inputs(lead=()):
    rng = np.random.default_rng(0)
    x0 = NOMINAL + 0.1 * rng.standard_normal(lead + (4,))
    us0 = 0.2 * rng.standard_normal(lead + (T, 2))
    tp = make_two_link_problem()
    xs0 = rollout(lambda x, u: problem_dynamics(tp, x, u), to_torch(x0),
                  to_torch(us0))
    return tp, xs0, to_torch(us0)


def test_trace_rows_against_jax():
    tp, xs0, us0 = inputs()
    cfg = config_from_fields(FLAGS)
    res, trace = solve_with_trace(tp, xs0, us0, config=cfg, device="cpu")
    jres, jtr = jax.jit(lambda a, b: jax_trace(jax_two_link(), a, b,
                                               config=JaxConfig(**FLAGS)))(
        jnp.asarray(xs0.numpy()), jnp.asarray(us0.numpy()))
    assert trace._fields == jtr._fields
    for name in ("backtracks", "status", "valid"):
        np.testing.assert_array_equal(getattr(trace, name).numpy(),
                                      np.asarray(getattr(jtr, name)), name)
    valid = trace.valid.numpy()
    assert 2 <= valid.sum() < FLAGS["max_iter"], valid
    for name in ("cost", "alpha", "du_sq", "dV1", "reg"):
        a = getattr(trace, name).numpy()
        b = np.asarray(getattr(jtr, name))
        assert_close(a[valid], b[valid], 1e-9, 1e-14, err_msg=name)
    assert np.isnan(trace.cost.numpy()[~valid]).all()
    for name in ("us", "xs", "cost"):
        assert_close(getattr(res, name), getattr(jres, name), 1e-9, 1e-12,
                     err_msg=name)
    assert int(res.status) == int(jres.status)
    # The result is the plain solve's, and its last valid row is the solve's
    # last iteration.
    plain = solve(tp, xs0, us0, config=cfg, device="cpu")
    for name, a, b in zip(plain._fields, res, plain):
        assert torch.equal(a, b), name
    last = int(valid.sum()) - 1
    assert int(trace.status[last]) == int(res.status)
    assert float(trace.du_sq[last]) == float(res.du_sq)


def test_batch_gives_a_trace_per_scenario():
    tp, xs0, us0 = inputs((3,))
    cfg = config_from_fields(dict(FLAGS, max_iter=6))
    res, trace = solve_with_trace(tp, xs0, us0, config=cfg, device="cpu")
    assert isinstance(trace, IterationTrace)
    for f in trace:
        assert f.shape == (3, 6)
    for b in range(3):
        _, one = solve_with_trace(tp, xs0[b], us0[b], config=cfg,
                                  device="cpu")
        for name, x, y in zip(trace._fields, trace, one):
            torch.testing.assert_close(x[b], y, rtol=1e-12, atol=0.0,
                                       equal_nan=True, msg=name)


def test_phase_timer_and_annotate(tmp_path):
    timer = PhaseTimer()
    for _ in range(2):
        with timer.phase("backward"):
            time.sleep(0.01)
    with timer.phase("forward"):
        pass
    assert timer.counts == {"backward": 2, "forward": 1}
    assert timer.totals["backward"] >= 0.02
    lines = timer.summary().splitlines()
    assert lines[0].startswith("backward:") and "over 2 calls" in lines[0]
    assert lines[1].startswith("forward:")

    with device_trace(str(tmp_path)):
        with annotate("riccati_phase"):
            torch.ones(8) @ torch.ones(8)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "riccati_phase" for e in events)
