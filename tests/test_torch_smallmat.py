"""``ilqr_tpu_torch.ops.smallmat`` against ``ilqr_tpu.ops.smallmat``: the
same numpy inputs through both, float64 on the CPU, rtol 1e-12 (the two
spell the same multiply-and-sum; only the order of a sum may differ)."""

import jax.numpy as jnp
import numpy as np
import pytest

from ilqr_tpu.ops import smallmat as jsm
from ilqr_tpu_torch.ops import smallmat as tsm
from tests.torch_parity import assert_close, to_torch

RTOL = 1e-12
B = 5

# name -> shapes of the two operands (leading-batch helpers get a leading
# batch of 3; the _bl helpers a trailing batch of B).
BINARY = {
    "mm": ((3, 4, 6), (3, 6, 2)),
    "mtm": ((3, 6, 4), (3, 6, 2)),
    "mmt": ((3, 4, 6), (3, 2, 6)),
    "mv": ((3, 4, 6), (3, 6)),
    "mtv": ((3, 6, 4), (3, 6)),
    "vv": ((3, 6), (3, 6)),
    "mm_bl": ((4, 6, B), (6, 2, B)),
    "mtm_bl": ((6, 4, B), (6, 2, B)),
    "mv_bl": ((4, 6, B), (6, B)),
    "mtv_bl": ((6, 4, B), (6, B)),
    "vv_bl": ((6, B), (6, B)),
}


@pytest.mark.parametrize("name", sorted(BINARY))
def test_products_match_jax(name):
    rng = np.random.default_rng(0)
    a, b = (rng.standard_normal(s) for s in BINARY[name])
    ref = getattr(jsm, name)(jnp.asarray(a), jnp.asarray(b))
    out = getattr(tsm, name)(to_torch(a), to_torch(b))
    assert_close(out, ref, RTOL, err_msg=name)


def test_transpose_bl_matches_jax():
    a = np.random.default_rng(1).standard_normal((4, 2, B))
    assert_close(tsm.transpose_bl(to_torch(a)), jsm.transpose_bl(jnp.asarray(a)),
                 0.0)


def _spd_bl(m, seed):
    rng = np.random.default_rng(seed)
    R = rng.standard_normal((m, m, B))
    A = np.einsum("ikb,jkb->ijb", R, R) + 0.5 * np.eye(m)[:, :, None]
    return A, rng


@pytest.mark.parametrize("m", [2, 5])
@pytest.mark.parametrize("per_lane_reg", [False, True])
def test_cholesky_and_solves_match_jax(m, per_lane_reg):
    A, rng = _spd_bl(m, 2 + m)
    reg = rng.uniform(1e-3, 1.0, B) if per_lane_reg else 1e-2
    reg_j = jnp.asarray(reg) if per_lane_reg else reg
    reg_t = to_torch(reg) if per_lane_reg else reg

    L_ref = jsm.cholesky_bl(jnp.asarray(A), reg_j)
    L = tsm.cholesky_bl(to_torch(A), reg_t)
    assert_close(L, L_ref, RTOL, err_msg="cholesky_bl")

    for shape in ((m, B), (m, 3, B)):
        b = rng.standard_normal(shape)
        ref = jsm.cho_solve_bl(L_ref, jnp.asarray(b))
        assert_close(tsm.cho_solve_bl(L, to_torch(b)), ref, RTOL,
                     err_msg=f"cho_solve_bl {shape}")
        assert_close(tsm.solve_psd_bl(to_torch(A), to_torch(b), reg_t),
                     jsm.solve_psd_bl(jnp.asarray(A), jnp.asarray(b), reg_j),
                     RTOL, err_msg=f"solve_psd_bl {shape}")


@pytest.mark.parametrize("m", [2, 5])
def test_rsqrt_factorization_agrees_with_sqrt(m):
    """The kernels' variant (one rsqrt per pivot, solves that multiply by
    the reciprocal diagonal) against the JAX sqrt-then-divide one: the same
    factor and the same solution to rtol 1e-12 in float64."""

    A, rng = _spd_bl(m, 20 + m)
    b = rng.standard_normal((m, 3, B))
    L_ref = jsm.cholesky_bl(jnp.asarray(A), 1e-2)
    L, inv_diag = tsm.cholesky_rsqrt_bl(to_torch(A), 1e-2)
    assert_close(L, L_ref, RTOL)
    assert_close(inv_diag * L[range(m), range(m)], np.ones((m, B)), RTOL)
    assert_close(tsm.cho_solve_bl(L, to_torch(b), inv_diag),
                 jsm.cho_solve_bl(L_ref, jnp.asarray(b)), 1e-11)
