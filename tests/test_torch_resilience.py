"""Host snapshots, resume and retry of the port's chunked solver, float64,
CPU, against its own uninterrupted solve and against the JAX package.

The 2-link arm at ten times the benchmark's step, B=8, T=24, ``iter_chunk=2``,
with a per-lane difficulty ramp so that lanes finish at different passes
(and compaction fires where it is asked for):

* a chunk that fails with ``torch.AcceleratorError`` is retried from the
  last host snapshot and the result is EQUAL to the uninterrupted solve;
  past ``max_retries`` consecutive faults, or with no snapshot to go back
  to, the error propagates; any other error (a ``RuntimeError`` of a launch
  that failed, say) is not retried;
* a solve stopped by an error leaves its ``snapshot_path`` file behind, a
  fresh solver resumes from it to the uninterrupted result (with and
  without compaction), and the file is gone afterwards — also when
  ``on_chunk`` stops the solve;
* cross-resume: a JAX chunked solve killed by its ``_fault_hook`` leaves
  its snapshot and the port resumes it to JAX's uninterrupted ``us`` (rtol
  1e-10), and the other way round.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_tpu.batched import make_chunked_batch_solver as jax_chunked
from ilqr_tpu.config import ILQRConfig as JaxConfig
from ilqr_tpu.models.two_link import TwoLinkParams as JaxParams
from ilqr_tpu.models.two_link import make_two_link_problem as jax_two_link
from ilqr_tpu_torch.batched import make_chunked_batch_solver, rollout_bl
from ilqr_tpu_torch.convert import config_from_fields
from ilqr_tpu_torch.models.two_link import (TwoLinkParams,
                                            make_two_link_problem)
from tests.torch_parity import NOMINAL, assert_close, to_torch

torch.set_num_threads(1)

B, T, DT = 8, 24, 0.1
FLAGS = dict(max_iter=30, tol=1e-5, tol_grad=1e-10, tol_grad_rel=1e-6,
             backward_backend="scan")
SIZES = (6, 4, 2)


class Killed(Exception):
    """Stands for whatever ends a process mid-solve."""


def ramp_inputs(seed=0):
    rng = np.random.default_rng(seed)
    x0s = NOMINAL + (np.linspace(0.05, 0.6, B)[:, None]
                     * rng.standard_normal((B, 4)))
    us0 = (np.linspace(0.0, 1.5, B)[:, None, None]
           * rng.standard_normal((B, T, 2)))
    tp = make_two_link_problem(TwoLinkParams(dt=DT))
    xs0 = rollout_bl(tp, to_torch(x0s.T), to_torch(us0).movedim(0, -1))
    return tp, xs0.movedim(-1, 0).contiguous(), to_torch(us0)


def solver(tp, **kw):
    kw.setdefault("iter_chunk", 2)
    return make_chunked_batch_solver(tp, config_from_fields(FLAGS),
                                     device="cpu", **kw)


def assert_results_equal(a, b):
    for name, x, y in zip(a._fields, a, b):
        assert torch.equal(x, y), name


class FaultAt:
    """``_fault_hook`` raising ``exc`` at chunk ``at``, ``times`` times."""

    def __init__(self, at, exc, times=1):
        self.at, self.exc, self.left, self.calls = at, exc, times, []

    def __call__(self, chunk_idx):
        self.calls.append(chunk_idx)
        if chunk_idx == self.at and self.left > 0:
            self.left -= 1
            raise self.exc


@pytest.mark.parametrize("snapshot_every,compact_sizes",
                         [(1, ()), (2, SIZES)], ids=["every-1", "every-2-compact"])
def test_retry_after_a_device_error_equals_the_solve(snapshot_every,
                                                     compact_sizes):
    tp, xs0, us0 = ramp_inputs()
    ref = solver(tp, compact_sizes=compact_sizes)(xs0, us0)
    hook = FaultAt(3, torch.AcceleratorError("injected"))
    res = solver(tp, compact_sizes=compact_sizes,
                 snapshot_every=snapshot_every, _fault_hook=hook)(xs0, us0)
    assert_results_equal(res, ref)
    assert hook.calls.count(3) == 2


def test_error_past_max_retries_propagates():
    tp, xs0, us0 = ramp_inputs()
    hook = FaultAt(1, torch.AcceleratorError("sticky"), times=10)
    with pytest.raises(torch.AcceleratorError, match="sticky"):
        solver(tp, snapshot_every=1, max_retries=2, _fault_hook=hook)(xs0, us0)
    assert hook.calls == [0, 1, 1, 1]


def test_device_error_without_a_snapshot_is_not_retried():
    tp, xs0, us0 = ramp_inputs()
    hook = FaultAt(1, torch.AcceleratorError("no snapshot"))
    with pytest.raises(torch.AcceleratorError):
        solver(tp, _fault_hook=hook)(xs0, us0)
    assert hook.calls == [0, 1]


@pytest.mark.parametrize("exc", [RuntimeError("launch failed"),
                                 ValueError("bug")],
                         ids=["RuntimeError", "ValueError"])
def test_other_errors_are_not_retried(exc):
    tp, xs0, us0 = ramp_inputs()
    hook = FaultAt(1, exc)
    with pytest.raises(type(exc)):
        solver(tp, snapshot_every=1, _fault_hook=hook)(xs0, us0)
    assert hook.calls == [0, 1]


@pytest.mark.parametrize("compact_sizes", [(), SIZES], ids=["full", "compact"])
def test_resume_from_the_snapshot_file(tmp_path, compact_sizes):
    tp, xs0, us0 = ramp_inputs()
    path = str(tmp_path / "solve.npz")
    ref = solver(tp, compact_sizes=compact_sizes)(xs0, us0)
    chunks = []
    with pytest.raises(Killed):
        solver(tp, compact_sizes=compact_sizes, snapshot_path=path,
               on_chunk=lambda p, r: chunks.append((p, r)) and False,
               _fault_hook=FaultAt(3, Killed()))(xs0, us0)
    assert os.path.exists(path)
    if compact_sizes:
        # The file holds the full batch, merged after compaction fired.
        assert any(0 < r <= SIZES[0] for _, r in chunks), chunks
    res = solver(tp, compact_sizes=compact_sizes, snapshot_path=path)(xs0,
                                                                      us0)
    assert not os.path.exists(path)
    assert_results_equal(res, ref)


def test_file_removed_when_on_chunk_stops(tmp_path):
    tp, xs0, us0 = ramp_inputs()
    path = str(tmp_path / "solve.npz")
    seen = []

    def stop_after_two(passes, running):
        seen.append(os.path.exists(path))
        return len(seen) == 2

    solver(tp, snapshot_path=path, on_chunk=stop_after_two)(xs0, us0)
    assert seen == [True, True]
    assert not os.path.exists(path)


def test_cross_resume_between_the_packages(tmp_path):
    tp, xs0, us0 = ramp_inputs()
    jcfg = JaxConfig(**FLAGS)
    jpath = str(tmp_path / "jax.npz")
    armed = []

    def jax_hook(chunk_idx):
        if armed and chunk_idx == 2:
            raise Killed()

    # One JAX solver (one compile): uninterrupted, then killed at chunk 2.
    jsolve = jax_chunked(jax_two_link(JaxParams(dt=DT)), jcfg, iter_chunk=2,
                         snapshot_path=jpath, _fault_hook=jax_hook)
    jxs0, jus0 = jnp.asarray(xs0.numpy()), jnp.asarray(us0.numpy())
    jref = jsolve(jxs0, jus0)
    assert not os.path.exists(jpath)
    armed.append(True)
    with pytest.raises(Killed):
        jsolve(jxs0, jus0)
    assert os.path.exists(jpath)

    # The port resumes the JAX snapshot.
    res = solver(tp, snapshot_path=jpath)(xs0, us0)
    assert not os.path.exists(jpath)
    np.testing.assert_array_equal(res.status.numpy(), np.asarray(jref.status))
    np.testing.assert_array_equal(res.iterations.numpy(),
                                  np.asarray(jref.iterations))
    assert_close(res.us, jref.us, 1e-10)

    # And JAX resumes the port's (the same JAX solver, disarmed).
    with pytest.raises(Killed):
        solver(tp, snapshot_path=jpath,
               _fault_hook=FaultAt(2, Killed()))(xs0, us0)
    assert os.path.exists(jpath)
    armed.clear()
    jres = jsolve(jxs0, jus0)
    assert not os.path.exists(jpath)
    np.testing.assert_array_equal(np.asarray(jres.status),
                                  np.asarray(jref.status))
    assert_close(res.us, jres.us, 1e-10)
