"""The ceiling of ``csrc/riccati_cluster.cu``, ``(128, 64)`` (a cluster of
four blocks a lane in float32, eight in float64), with ``symmetrize`` on:
the plain version through both entries, B=2, T=2, float64, against the JAX
``backward.riccati_step`` run eagerly, each output within 1e-10 of its
largest magnitude, as ``tests/test_torch_riccati_cluster.py`` holds the
smaller shapes.  ``symmetrize`` off is held in
``tests/test_torch_riccati_cluster_ceiling_raw.py``: at m = 64 the JAX
step's scalar-unrolled Cholesky takes seconds a step here, and the two
would pass half a minute in one file.
"""

from tests.test_torch_riccati_cluster import check_against_jax


def test_plain_at_the_ceiling_symmetrized_matches_the_jax_step():
    check_against_jax(128, 64, symmetrize=True)
