"""The ceiling of ``csrc/riccati_cluster.cu``, ``(128, 64)`` (a cluster of
four blocks a lane in float32, eight in float64), with ``symmetrize`` off:
the plain version through both entries, B=2, T=2, float64, against the JAX
``backward.riccati_step`` run eagerly, each output within 1e-10 of its
largest magnitude, as ``tests/test_torch_riccati_cluster.py`` holds the
smaller shapes.  ``symmetrize`` on is held in
``tests/test_torch_riccati_cluster_ceiling.py``.
"""

from tests.test_torch_riccati_cluster import check_against_jax


def test_plain_at_the_ceiling_unsymmetrized_matches_the_jax_step():
    check_against_jax(128, 64, symmetrize=False)
