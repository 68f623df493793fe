"""The port's checkpointed fleet MPC (``parallel.mpc.batch_mpc_run_chunked``),
float64, CPU.

* against the JAX package's ``batch_mpc_run_chunked`` on the same fleet:
  every field, ``statuses`` and ``iterations`` identical, trajectories to
  rtol 1e-9 (moderate scenarios, so that replans do not amplify rounding:
  ``ROADMAP.md`` C11);
* against the port's ``batch_mpc_run`` at the same ``n_steps``: EQUAL;
* stopped by ``on_chunk`` after the first chunk, the run leaves its
  checkpoint, and a second call resumes from it to the same result; the
  checkpoint holds the JAX package's keys and dtypes, and a JAX checkpoint
  resumes in the port;
* ``n_steps`` must be a multiple of ``step_chunk``.
"""

import functools
import os
import shutil
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_tpu.config import ILQRConfig as JaxConfig
from ilqr_tpu.models.two_link import make_two_link_problem as jax_two_link
from ilqr_tpu.parallel.mpc import batch_mpc_run_chunked as jax_chunked_mpc
from ilqr_tpu_torch.convert import config_from_fields
from ilqr_tpu_torch.models.two_link import make_two_link_problem
from ilqr_tpu_torch.parallel.mpc import batch_mpc_run, batch_mpc_run_chunked
from tests.torch_parity import assert_close, to_torch

torch.set_num_threads(1)

B, H, STEPS, CHUNK = 3, 8, 4, 2
FLAGS = dict(max_iter=10, tol=1e-6, tol_grad=1e-10, tol_grad_rel=1e-6)
KEYS = {"step": np.int64, "x": np.float64, "us_warm": np.float64,
        "xs": np.float64, "us": np.float64, "costs": np.float64,
        "iters": np.int32, "statuses": np.int32}


def fleet(seed=0):
    rng = np.random.default_rng(seed)
    return np.array([0.1, -0.1, 0.0, 0.0]) + 0.1 * rng.standard_normal((B, 4))


@functools.lru_cache(maxsize=None)
def jax_reference():
    """The JAX run's result, and a copy of its checkpoint after the first
    chunk (one compile for both)."""

    tmp = tempfile.mkdtemp()
    path, mid = os.path.join(tmp, "jax.npz"), os.path.join(tmp, "mid.npz")

    def keep_first(step):
        if step == CHUNK:
            shutil.copy(path, mid)

    res = jax_chunked_mpc(jax_two_link(), jnp.asarray(fleet()), H, STEPS,
                          config=JaxConfig(**FLAGS), step_chunk=CHUNK,
                          checkpoint_path=path, on_chunk=keep_first)
    return {f: np.asarray(getattr(res, f)) for f in res._fields}, mid


def run(**kw):
    return batch_mpc_run_chunked(make_two_link_problem(), to_torch(fleet()),
                                 H, STEPS, config=config_from_fields(FLAGS),
                                 step_chunk=CHUNK, device="cpu", **kw)


def assert_equal(a, b):
    for name, x, y in zip(a._fields, a, b):
        assert torch.equal(x, y), name


def test_against_jax_chunked_mpc():
    res = run()
    ref, _ = jax_reference()
    np.testing.assert_array_equal(res.statuses.numpy(), ref["statuses"])
    np.testing.assert_array_equal(res.iterations.numpy(), ref["iterations"])
    assert_close(res.xs, ref["xs"], 1e-9, 1e-12)
    assert_close(res.us, ref["us"], 1e-9, 1e-12)
    assert_close(res.costs, ref["costs"], 1e-9)


def test_equals_batch_mpc_run():
    ref = batch_mpc_run(make_two_link_problem(), to_torch(fleet()), H, STEPS,
                        config=config_from_fields(FLAGS), device="cpu")
    assert_equal(run(), ref)


def test_stop_and_resume(tmp_path):
    path = str(tmp_path / "fleet.npz")
    full = run()
    seen = []
    part = run(checkpoint_path=path,
               on_chunk=lambda step: seen.append(step) or True)
    assert seen == [CHUNK]
    # The steps not run are zero-filled.
    assert torch.equal(part.us[:, :CHUNK], full.us[:, :CHUNK])
    assert not bool(part.us[:, CHUNK:].any())
    saved = np.load(path)
    assert sorted(k[len("path:"):] for k in saved.files
                  if k.startswith("path:")) == sorted(
                      f"[{k!r}]" for k in KEYS)
    for k, dtype in KEYS.items():
        assert saved[f"path:[{k!r}]"].dtype == dtype, k
    assert int(saved["path:['step']"]) == CHUNK
    assert_equal(run(checkpoint_path=path), full)


def test_jax_checkpoint_resumes_in_the_port():
    ref, mid = jax_reference()
    saved = np.load(mid)
    assert int(saved["path:['step']"]) == CHUNK
    res = run(checkpoint_path=mid)
    np.testing.assert_array_equal(res.statuses.numpy(), ref["statuses"])
    assert_close(res.us, ref["us"], 1e-9, 1e-12)


def test_n_steps_must_be_a_multiple_of_step_chunk():
    with pytest.raises(AssertionError):
        batch_mpc_run_chunked(make_two_link_problem(), to_torch(fleet()), H,
                              5, step_chunk=2, device="cpu")
