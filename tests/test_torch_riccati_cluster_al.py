"""``csrc/riccati_cluster.cu`` at ``(73, 36)``, the free-flying five-arm
under ``al_solve`` (its state carries the step index): the plain version
through both entries, B=2, T=2, float64, ``symmetrize`` on and off, against
the JAX ``backward.riccati_step`` run eagerly, each output within 1e-10 of
its largest magnitude, as ``tests/test_torch_riccati_cluster.py`` holds the
five-arm's ``(72, 36)``.
"""

import pytest

from tests.test_torch_riccati_cluster import check_against_jax


@pytest.mark.parametrize("symmetrize", [True, False])
def test_plain_at_73x36_matches_the_jax_step(symmetrize):
    check_against_jax(73, 36, symmetrize)
