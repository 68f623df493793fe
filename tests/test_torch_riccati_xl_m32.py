"""The Riccati kernel's ceiling, ``m = 32``: the plain version at ``(20,
32)`` (more controls than states) and ``(64, 32)`` (the largest shape
``csrc/riccati_xl.cu`` serves), both entries, ``symmetrize`` on and off,
against the JAX ``backward.riccati_scan`` at 1e-10 of each output's largest
magnitude, float64, CPU, as ``tests/test_torch_riccati_xl.py`` holds the
smaller shapes.  A file of its own: the JAX recursion runs eagerly, and at
m = 32 its scalar-unrolled Cholesky takes seconds a step here, so the
horizon is T = 2 (the second step reads the carry the first symmetrized or
not), one lane.
"""

import pytest

from tests.test_torch_riccati_xl import check_against_jax_scan


@pytest.mark.parametrize("symmetrize", [True, False])
@pytest.mark.parametrize("n,m", [(20, 32), (64, 32)])
def test_plain_at_m32_matches_the_jax_scan(n, m, symmetrize):
    check_against_jax_scan(n, m, symmetrize, T=2, B=1)
