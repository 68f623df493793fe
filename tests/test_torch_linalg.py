"""The port's unrolled small-matrix algebra against the JAX package's.

The same numpy inputs, made from a seed, go through ``ilqr_tpu.ops.linalg``
and ``ilqr_tpu_torch.ops.linalg`` in float64 on the CPU.  The port runs the
JAX recurrences element for element (a column at a time instead of an entry
at a time), so the results agree to rounding: rtol 1e-12, with an atol of
1e-13 for entries that cancel to nearly zero.  ``regularized_pinv`` goes
through each framework's own SVD and is held to rtol 1e-9.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_tpu.ops import linalg as jl
from ilqr_tpu_torch.ops import linalg as tl
from tests.torch_parity import assert_close, to_torch

RTOL, ATOL = 1e-12, 1e-13


def random_psd(rng, m, batch=()):
    A = rng.standard_normal(batch + (m, m))
    return A @ np.swapaxes(A, -1, -2) + m * np.eye(m)


@pytest.mark.parametrize("batch", [(), (5,), (2, 3)])
@pytest.mark.parametrize("m", [1, 2, 4, 8, 12])
def test_cholesky_small(m, batch):
    A = random_psd(np.random.default_rng(m), m, batch)
    L = tl.cholesky_small(to_torch(A))
    assert_close(L, jl.cholesky_small(jnp.asarray(A)), RTOL, ATOL)
    assert torch.equal(L, torch.tril(L))


@pytest.mark.parametrize("rhs", ["vector", "matrix"])
@pytest.mark.parametrize("m", [1, 3, 8, 12])
def test_triangular_solves(m, rhs):
    rng = np.random.default_rng(10 + m)
    L = np.linalg.cholesky(random_psd(rng, m, (4,)))
    b = rng.standard_normal((4, m) if rhs == "vector" else (4, m, 5))
    assert_close(tl.solve_tri_lower(to_torch(L), to_torch(b)),
                 jl.solve_tri_lower(jnp.asarray(L), jnp.asarray(b)),
                 RTOL, ATOL)
    U = np.swapaxes(L, -1, -2)
    assert_close(tl.solve_tri_upper(to_torch(U), to_torch(b)),
                 jl.solve_tri_upper(jnp.asarray(U), jnp.asarray(b)),
                 RTOL, ATOL)


@pytest.mark.parametrize("rhs", ["vector", "matrix"])
@pytest.mark.parametrize("m", [2, 8, 12])
def test_solve_psd_small(m, rhs):
    rng = np.random.default_rng(20 + m)
    A = random_psd(rng, m, (3,))
    b = rng.standard_normal((3, m) if rhs == "vector" else (3, m, 2 * m + 1))
    x = tl.solve_psd_small(to_torch(A), to_torch(b))
    assert_close(x, jl.solve_psd_small(jnp.asarray(A), jnp.asarray(b)),
                 RTOL, ATOL)
    np.testing.assert_allclose(
        x.numpy(), np.linalg.solve(A, b[..., None] if rhs == "vector" else b
                                   ).reshape(x.shape), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("rhs", ["vector", "matrix"])
@pytest.mark.parametrize("m", [1, 2, 4, 9])
def test_solve_general_small(m, rhs):
    rng = np.random.default_rng(30 + m)
    A = rng.standard_normal((6, m, m))
    A[0, 0, 0] = 0.0  # a zero leading pivot forces the row swap
    b = rng.standard_normal((6, m) if rhs == "vector" else (6, m, 3))
    assert_close(tl.solve_general_small(to_torch(A), to_torch(b)),
                 jl.solve_general_small(jnp.asarray(A), jnp.asarray(b)),
                 1e-11, 1e-12)


def test_regularized_pinv():
    rng = np.random.default_rng(40)
    A = rng.standard_normal((3, 5, 5))
    assert_close(tl.regularized_pinv(to_torch(A), reg=1e-3),
                 jl.regularized_pinv(jnp.asarray(A), reg=1e-3), 1e-9, 1e-11)


def test_float32_stays_float32_and_safe_under_func_transforms():
    rng = np.random.default_rng(50)
    A = to_torch(random_psd(rng, 4, (3,))).float()
    b = to_torch(rng.standard_normal((3, 4))).float()
    x = tl.solve_psd_small(A, b)
    assert x.dtype == torch.float32
    # jvp and vmap trace through (nothing is written in place).
    _, dx = torch.func.jvp(lambda bb: tl.solve_psd_small(A, bb), (b,),
                           (torch.ones_like(b),))
    assert_close(dx.double(), tl.solve_psd_small(A.double(),
                                                 torch.ones_like(b).double()),
                 1e-5, 1e-6)
    xv = torch.func.vmap(tl.solve_psd_small)(A, b)
    assert torch.allclose(xv, x, rtol=1e-6, atol=1e-7)
