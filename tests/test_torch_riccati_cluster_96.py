"""``csrc/riccati_cluster.cu`` at ``(96, 48)`` (a cluster of two blocks a
lane in float32, four in float64): the plain version through both entries,
B=2, T=2, float64, ``symmetrize`` on and off, against the JAX
``backward.riccati_step`` run eagerly, each output within 1e-10 of its
largest magnitude, as ``tests/test_torch_riccati_cluster.py`` holds the
smaller shapes.
"""

import pytest

from tests.test_torch_riccati_cluster import check_against_jax


@pytest.mark.parametrize("symmetrize", [True, False])
def test_plain_at_96x48_matches_the_jax_step(symmetrize):
    check_against_jax(96, 48, symmetrize)
