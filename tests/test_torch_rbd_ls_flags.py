"""The port's chunked solve of the floating-base 2-DoF arm under the line
search's flags against the JAX package's, float64, CPU:
``make_chunked_batch_solver`` with ``bench.py --config rbd``'s solver flags
(Tassa regularization) and ``--ls-warm --ls-expected --ls-c 0.4`` plus
``exact_ls_delta`` (``--exact-delta``), B=4 scenarios from its
distribution, T=20, 3 passes in chunks of one pass, so that each ladder
after the first starts from the alpha carried across a chunk boundary.
The first pass accepts alpha 1 (its previous cost is infinite); at T=20
every lane's second pass accepts 1/8, so the third ladder starts at 1/4
and skips two rungs (at T=10 the second accepts 1/2 or 1, and the warm
start would start at alpha0 anyway).

The JAX side is a frozen fixture, ``tests/fixtures/rbd_ls_flags_B4_T20.npz``:
the JAX package's open-loop rollout of the inputs and its chunked solve
from there (its scan backend: the Pallas kernel's interpret mode at n=16
takes the CPU compiler many minutes).  Compiling that solve takes XLA
minutes on a CPU, so it does not build within this file's time; the
fixture is written by ``python -m tests.test_torch_rbd_ls_flags`` and the
JAX package is not edited, so it stays its output.

Status, iterations and the carried alpha (the line search's decisions)
exactly; ``us``, ``xs``, cost and reg to rtol 1e-8 / atol 1e-10.  The
warm start changes the rungs a ladder tries, not what it accepts here, so
the rollouts are counted: fewer with it than without.  ``exact_ls_delta``
decides as the rounded totals do in float64 (its point is float32's cost
resolution); its per-step sums are held through the JAX result.  The
port's ``backward_backend="pallas"`` (on CPU tensors the CUDA kernel's
plain version) equals its ``"scan"`` to 1e-10, the alphas exactly.
"""

import pathlib

import numpy as np

from ilqr_tpu_torch import batched
from ilqr_tpu_torch.batched import closed_loop_rollout_bl
from ilqr_tpu_torch.config import ILQRConfig
from ilqr_tpu_torch.convert import result_to_numpy
from ilqr_tpu_torch.models.rbd import make_rbd_arm_problem
from ilqr_tpu_torch.ops import cuda_riccati
from tests.torch_parity import assert_close, to_torch

FIXTURE = (pathlib.Path(__file__).resolve().parent / "fixtures"
           / "rbd_ls_flags_B4_T20.npz")
B, T, PASSES = 4, 20, 3
NOMINAL = np.array([0.0, 0.0, 1.0, 0.5, 0.75, 1.0, 0.0, 0.0] + [0.0] * 8)
SCALE = np.array([0.4 * 0.05] * 3 + [0.05] * 5 + [0.0] * 8)
# bench.py:372-393 with --ls-warm --ls-expected --ls-c 0.4 --exact-delta.
FLAGS = dict(max_iter=PASSES, tol=1e-5, tol_grad=1e-10, tol_grad_rel=1e-6,
             adaptive_reg=True, reg=1.0, reg_min=1e-3, reg_scale=10.0,
             reg_backtrack_trigger=1, ls_expected_decrease=True, ls_c=0.4,
             ls_alpha_warm_start=True, exact_ls_delta=True)
FIELDS = ("xs", "us", "cost", "iterations", "status", "reg", "alpha")


def inputs():
    x0s = NOMINAL + SCALE * np.random.default_rng(0).standard_normal((B, 16))
    return x0s, np.zeros((B, T, 8))


def port_solve(xs0, us0, backend, **flags):
    cfg = ILQRConfig(**dict(FLAGS, **flags), backward_backend=backend)
    return batched.make_chunked_batch_solver(
        make_rbd_arm_problem(), cfg, iter_chunk=1, device="cpu")(
            to_torch(xs0), to_torch(us0))


def test_chunked_solve_with_line_search_flags_against_jax():
    ref = np.load(FIXTURE)
    x0s, us0 = inputs()
    np.testing.assert_array_equal(ref["x0s"], x0s)
    xs0 = batched.rollout_bl(make_rbd_arm_problem(), to_torch(x0s).T,
                             to_torch(us0).movedim(0, -1)).movedim(-1, 0)
    assert_close(xs0, ref["xs0"], 1e-12, 1e-14, err_msg="xs0")
    out = result_to_numpy(port_solve(ref["xs0"], us0, "scan"))
    # The line search's decisions: the carried alphas are powers of two.
    for f in ("status", "iterations", "alpha"):
        np.testing.assert_array_equal(out[f], ref[f], err_msg=f)
    for name in ("xs", "us", "cost", "reg"):
        assert_close(out[name], ref[name], 1e-8, 1e-10, err_msg=name)


def test_warm_start_skips_rungs(monkeypatch):
    ref = np.load(FIXTURE)
    _, us0 = inputs()
    rollouts = []

    def counted(*args, **kw):
        rollouts.append(float(args[-1].max()))
        return closed_loop_rollout_bl(*args, **kw)

    monkeypatch.setattr(batched, "closed_loop_rollout_bl", counted)
    warm = result_to_numpy(port_solve(ref["xs0"], us0, "scan"))
    n_warm = len(rollouts)
    rollouts.clear()
    cold = result_to_numpy(port_solve(ref["xs0"], us0, "scan",
                                      ls_alpha_warm_start=False))
    # The same decisions, two rungs fewer: the third ladder starts at twice
    # the second pass's alpha, 1/8.
    np.testing.assert_array_equal(warm["alpha"], cold["alpha"])
    assert (warm["alpha"] == 0.125).all(), warm["alpha"]
    assert n_warm == len(rollouts) - 2, (n_warm, rollouts)


def test_pallas_path_equals_scan(monkeypatch):
    ref = np.load(FIXTURE)
    _, us0 = inputs()
    calls = []

    def counted(*args, **kw):
        calls.append(args[0].shape)
        return cuda_riccati.riccati_scan_plain_bl(*args, **kw)

    monkeypatch.setattr(batched, "riccati_scan_cuda_bl", counted)
    got = result_to_numpy(port_solve(ref["xs0"], us0, "pallas"))
    want = result_to_numpy(port_solve(ref["xs0"], us0, "scan"))
    assert len(calls) == PASSES, calls
    for f in ("status", "iterations", "alpha"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    for name in ("xs", "us", "cost", "reg"):
        assert_close(got[name], want[name], 1e-10, 1e-12, err_msg=name)


def jax_reference():
    """The JAX package's rollout of :func:`inputs` and its chunked solve
    from there, as numpy arrays (minutes of XLA compilation on a CPU)."""

    import jax
    import jax.numpy as jnp

    from ilqr_tpu.batched import make_chunked_batch_solver, rollout_bl
    from ilqr_tpu.config import ILQRConfig as JaxConfig
    from ilqr_tpu.models.rbd.model import make_rbd_arm_problem as jax_rbd

    problem = jax_rbd()
    x0s, us0 = (jnp.asarray(a) for a in inputs())
    xs0 = jnp.moveaxis(jax.jit(lambda x, u: rollout_bl(
        problem, x.T, jnp.moveaxis(u, 0, -1)))(x0s, us0), -1, 0)
    r = make_chunked_batch_solver(problem, JaxConfig(**FLAGS),
                                  iter_chunk=1)(xs0, us0)
    return dict({name: np.asarray(getattr(r, name)) for name in FIELDS},
                xs0=np.asarray(xs0))


if __name__ == "__main__":
    import time

    import jax

    jax.config.update("jax_enable_x64", True)
    jax.config.update("jax_default_device", jax.devices("cpu")[0])
    t0 = time.perf_counter()
    arrays = jax_reference()
    np.savez(FIXTURE, x0s=inputs()[0], **arrays)
    print(f"wrote {FIXTURE} in {time.perf_counter() - t0:.1f} s")
