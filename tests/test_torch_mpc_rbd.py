"""The port's fleet MPC of the floating-base 2-DoF arm against the JAX
package's, float64, CPU: ``batch_mpc_run`` with ``bench.py --config
mpc_batch --problem rbd``'s solver flags (Tassa regularization), B=2
scenarios from its distribution (attitude 0.02, pose 0.05 about the
reference's start, at rest), horizon 8, 2 control steps.

The JAX side is a frozen fixture, ``tests/fixtures/mpc_rbd_B2_H8.npz``: the
JAX package's jitted ``batch_mpc_run`` on these inputs (its scan backend;
the Pallas kernel's interpret mode at n=16 takes the CPU compiler many
minutes).  Compiling that program takes XLA minutes on a CPU, and run
eagerly one RBD dynamics call takes half a second, so neither the program
nor a replan's un-jitted solve fits this file's time; the fixture is
written by ``python -m tests.test_torch_mpc_rbd`` and the JAX package is
not edited, so it stays its output.

Statuses and iterations exactly; states, applied controls and planned
costs to rtol 1e-8 / atol 1e-10 (two float64 programs, other orders of the
sums, over two warm-started replans of up to 10 iterations).  The port's
``backward_backend="pallas"`` (on CPU tensors the CUDA kernel's plain
version, through the batch-first entry) equals its ``"scan"`` to 1e-10.
"""

import pathlib

import numpy as np

from ilqr_tpu_torch.config import ILQRConfig
from ilqr_tpu_torch.convert import result_to_numpy
from ilqr_tpu_torch.models.rbd import make_rbd_arm_problem
from ilqr_tpu_torch.ops import cuda_riccati, riccati_dispatch
from ilqr_tpu_torch.parallel import batch_mpc_run
from tests.torch_parity import assert_close, to_torch

FIXTURE = (pathlib.Path(__file__).resolve().parent / "fixtures"
           / "mpc_rbd_B2_H8.npz")
B, H, STEPS = 2, 8, 2
NOMINAL = np.array([0.0, 0.0, 1.0, 0.5, 0.75, 1.0, 0.0, 0.0] + [0.0] * 8)
SCALE = np.array([0.02] * 3 + [0.05] * 5 + [0.0] * 8)
# bench.py:239-244 (its scan_unroll=1 is the JAX scan's unroll factor).
FLAGS = dict(max_iter=10, tol=1e-5, tol_grad=1e-10, tol_grad_rel=1e-6,
             adaptive_reg=True, reg=1.0, reg_min=1e-3, reg_scale=10.0,
             reg_backtrack_trigger=1, scan_unroll=1)
RTOL, ATOL = 1e-8, 1e-10
FIELDS = ("xs", "us", "costs", "iterations", "statuses")


def x0s():
    return NOMINAL + SCALE * np.random.default_rng(0).standard_normal((B, 16))


def port_run(backend):
    return batch_mpc_run(make_rbd_arm_problem(), to_torch(x0s()), H, STEPS,
                         ILQRConfig(**FLAGS, backward_backend=backend),
                         device="cpu")


def test_batch_mpc_run_against_jax():
    ref = np.load(FIXTURE)
    np.testing.assert_array_equal(ref["x0s"], x0s())
    out = result_to_numpy(port_run("scan"))
    np.testing.assert_array_equal(out["statuses"], ref["statuses"])
    np.testing.assert_array_equal(out["iterations"], ref["iterations"])
    for name in ("xs", "us", "costs"):
        assert_close(out[name], ref[name], RTOL, ATOL, err_msg=name)


def test_pallas_path_equals_scan(monkeypatch):
    calls = []

    def counted(*args, **kw):
        calls.append(args[0].shape)
        return cuda_riccati.riccati_scan_cuda_batched(*args, **kw)

    monkeypatch.setattr(riccati_dispatch, "riccati_scan_cuda_batched",
                        counted)
    got = result_to_numpy(port_run("pallas"))
    want = result_to_numpy(port_run("scan"))
    # Every pass of every replan went through the batch-first entry, with
    # the fleet as its batch.
    assert len(calls) == int(want["iterations"].max(axis=0).sum())
    assert all(s[0] == B and s[-1] == 16 for s in calls), calls
    np.testing.assert_array_equal(got["statuses"], want["statuses"])
    np.testing.assert_array_equal(got["iterations"], want["iterations"])
    for name in ("xs", "us", "costs"):
        assert_close(got[name], want[name], 1e-10, 1e-12, err_msg=name)


def jax_reference():
    """The JAX package's jitted ``batch_mpc_run`` on :func:`x0s`, as
    numpy arrays (minutes of XLA compilation on a CPU)."""

    import jax
    import jax.numpy as jnp

    from ilqr_tpu.config import ILQRConfig as JaxConfig
    from ilqr_tpu.models.rbd.model import make_rbd_arm_problem as jax_rbd
    from ilqr_tpu.parallel import mpc as jmpc

    problem, cfg = jax_rbd(), JaxConfig(**FLAGS)
    r = jax.jit(lambda x: jmpc.batch_mpc_run(problem, x, H, STEPS, cfg))(
        jnp.asarray(x0s()))
    return {name: np.asarray(getattr(r, name)) for name in FIELDS}


if __name__ == "__main__":
    import time

    import jax

    jax.config.update("jax_enable_x64", True)
    jax.config.update("jax_default_device", jax.devices("cpu")[0])
    t0 = time.perf_counter()
    arrays = jax_reference()
    np.savez(FIXTURE, x0s=x0s(), **arrays)
    print(f"wrote {FIXTURE} in {time.perf_counter() - t0:.1f} s")
