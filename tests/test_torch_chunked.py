"""The port's chunked solver with straggler compaction, float64, CPU.

``make_chunked_batch_solver`` on the 2-link arm (ten times the benchmark's
step) with a per-lane difficulty ramp in the initial state and controls:
early lanes converge in 5 to 7 iterations, late lanes take up to 16 — the
straggler population compaction is for:

* against the port's own ``batched_solve_fused``: the step body is per
  lane, so with and without compaction every field is EQUAL, bit for bit;
* against ``ilqr_tpu.batched.make_chunked_batch_solver`` with the same
  ``compact_sizes``: ``status`` and ``iterations`` identical, ``us`` to rtol
  1e-8 / atol 1e-10 (two float64 programs, sums in another order), and the
  same ``(passes, running)`` reported to ``on_chunk`` chunk by chunk, so the
  compaction fired at the same points;
* ``on_chunk`` returning True stops the solve; ``x_ref`` follows the lanes
  through the gather; the arguments of the host snapshots and the retry
  change nothing when no fault occurs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_tpu.batched import make_chunked_batch_solver as jax_chunked
from ilqr_tpu.config import ILQRConfig as JaxConfig
from ilqr_tpu.models.two_link import TwoLinkParams as JaxParams
from ilqr_tpu.models.two_link import make_two_link_problem as jax_two_link
from ilqr_tpu_torch.batched import (batched_solve_fused,
                                    make_chunked_batch_solver, rollout_bl)
from ilqr_tpu_torch.config import Status
from ilqr_tpu_torch.convert import config_from_fields, result_to_numpy
from ilqr_tpu_torch.models.two_link import (TwoLinkParams,
                                            make_two_link_problem)
from tests.torch_parity import NOMINAL, assert_close, to_torch

torch.set_num_threads(1)

B, T, DT = 12, 24, 0.1
FLAGS = dict(max_iter=30, tol=1e-5, tol_grad=1e-10, tol_grad_rel=1e-6,
             backward_backend="scan")


def ramp_inputs(seed=0):
    """``xs0 [B, T+1, 4]`` (open-loop rollouts) and ``us0 [B, T, 2]``."""

    rng = np.random.default_rng(seed)
    x0s = NOMINAL + (np.linspace(0.05, 0.6, B)[:, None]
                     * rng.standard_normal((B, 4)))
    us0 = (np.linspace(0.0, 1.5, B)[:, None, None]
           * rng.standard_normal((B, T, 2)))
    tp = make_two_link_problem(TwoLinkParams(dt=DT))
    xs0 = rollout_bl(tp, to_torch(x0s.T), to_torch(us0).movedim(0, -1))
    return tp, xs0.movedim(-1, 0).contiguous(), to_torch(us0)


def assert_results_equal(a, b):
    for name, x, y in zip(a._fields, a, b):
        assert torch.equal(x, y), name


@pytest.mark.parametrize("compact_sizes", [(), (8, 4), (4,), (8, 6, 2)])
def test_chunked_equals_fused(compact_sizes):
    tp, xs0, us0 = ramp_inputs()
    cfg = config_from_fields(FLAGS)
    ref = batched_solve_fused(tp, xs0, us0, config=cfg, device="cpu")
    chunks = []
    solve = make_chunked_batch_solver(
        tp, cfg, iter_chunk=2, compact_sizes=compact_sizes, device="cpu",
        on_chunk=lambda p, r: chunks.append((p, r)) and False)
    res = solve(xs0, us0)
    assert_results_equal(res, ref)
    assert res.status.dtype == res.iterations.dtype == torch.int32
    # The ramp spreads the iteration counts, so the sizes do fire.
    assert int(res.iterations.max()) >= 2 * int(res.iterations.min())
    if compact_sizes:
        assert any(0 < r <= max(compact_sizes) for _, r in chunks[:-1]), chunks
    assert chunks[-1][0] == int(res.iterations.max())
    assert [p for p, _ in chunks[:-1]] == list(range(2, chunks[-1][0], 2))


def test_chunked_matches_jax_chunked_with_compaction():
    tp, xs0, us0 = ramp_inputs()
    jcfg = JaxConfig(**FLAGS)
    sizes = (8, 4)
    jchunks, tchunks = [], []
    ref = jax_chunked(
        jax_two_link(JaxParams(dt=DT)), jcfg, iter_chunk=3, compact_sizes=sizes,
        on_chunk=lambda p, r: jchunks.append((p, r)) and False)(
            jnp.asarray(xs0.numpy()), jnp.asarray(us0.numpy()))
    res = make_chunked_batch_solver(
        tp, config_from_fields(jcfg), iter_chunk=3, compact_sizes=sizes,
        device="cpu",
        on_chunk=lambda p, r: tchunks.append((p, r)) and False)(xs0, us0)
    out = result_to_numpy(res)
    assert tchunks == jchunks
    assert any(0 < r <= 8 for _, r in tchunks[:-1]), tchunks
    np.testing.assert_array_equal(out["status"], np.asarray(ref.status))
    np.testing.assert_array_equal(out["iterations"],
                                  np.asarray(ref.iterations))
    assert_close(out["us"], ref.us, 1e-8, 1e-10)
    assert_close(out["xs"], ref.xs, 1e-8, 1e-10)
    assert_close(out["cost"], ref.cost, 1e-8)
    assert_close(out["reg"], ref.reg, 1e-12)


def test_on_chunk_stops_the_solve():
    tp, xs0, us0 = ramp_inputs()
    cfg = config_from_fields(FLAGS)
    seen = []

    def stop_after_two(passes, running):
        seen.append((passes, running))
        return len(seen) == 2

    res = make_chunked_batch_solver(tp, cfg, iter_chunk=2, device="cpu",
                                    on_chunk=stop_after_two)(xs0, us0)
    assert [p for p, _ in seen] == [2, 4]
    assert int(res.iterations.max()) == 4
    # Lanes cut while RUNNING report MAX_ITER, as in the fused solve.
    cut = batched_solve_fused(tp, xs0, us0,
                              config=cfg.replace(max_iter=4), device="cpu")
    assert_results_equal(res, cut)
    assert bool((res.status == int(Status.MAX_ITER)).any())


def test_x_ref_follows_the_lanes_through_compaction():
    tp, xs0, us0 = ramp_inputs()
    cfg = config_from_fields(FLAGS)
    x_ref = to_torch(0.05 * np.random.default_rng(3).standard_normal(
        (B, T + 1, 4)))
    ref = batched_solve_fused(tp, xs0, us0, x_ref=x_ref, config=cfg,
                              device="cpu")
    res = make_chunked_batch_solver(tp, cfg, iter_chunk=2, x_ref=x_ref,
                                    compact_sizes=(8, 4), device="cpu")(
                                        xs0, us0)
    assert_results_equal(res, ref)
    no_ref = batched_solve_fused(tp, xs0, us0, config=cfg, device="cpu")
    assert not torch.equal(no_ref.cost, ref.cost)


REFUSED = {
    "snapshot_every > 0": dict(snapshot_every=4),
    "snapshot_path": dict(snapshot_path="state.npz"),
    "max_retries": dict(max_retries=5),
    "_fault_hook": dict(_fault_hook=lambda i: None),
}


@pytest.mark.parametrize("arg", sorted(REFUSED))
def test_unported_arguments_raise_and_name_themselves(arg, tmp_path):
    """Refused until the host snapshots, the resume and the retry were
    ported; now each argument is accepted and, with no fault, changes no
    lane's result (``tests/test_torch_resilience.py`` tests what they do)."""

    kw = dict(REFUSED[arg])
    if "snapshot_path" in kw:
        kw["snapshot_path"] = str(tmp_path / kw["snapshot_path"])
    tp, xs0, us0 = ramp_inputs()
    cfg = config_from_fields(FLAGS)
    ref = make_chunked_batch_solver(tp, cfg, iter_chunk=2,
                                    device="cpu")(xs0, us0)
    res = make_chunked_batch_solver(tp, cfg, iter_chunk=2, device="cpu",
                                    **kw)(xs0, us0)
    assert_results_equal(res, ref)
    assert not (tmp_path / "state.npz").exists()


def test_default_device_is_the_card():
    """No ``device="cpu"``: the solver asks for the card and, where there is
    none, says so instead of running on the CPU."""

    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_chunked_batch_solver(make_two_link_problem())
