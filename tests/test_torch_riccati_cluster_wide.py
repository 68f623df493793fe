"""The Riccati kernel past ``(64, 32)`` at the shapes that stretch
``csrc/riccati_cluster.cu``'s plan: ``(20, 40)`` (``m`` past 32 with a small
``n``: the factor no longer fits a warp at a row a lane); ``(96, 48)`` is
in ``tests/test_torch_riccati_cluster_96.py`` and the ceiling ``(128, 64)``
in ``tests/test_torch_riccati_cluster_ceiling*.py``, a file each so that
each stays under half a minute.
The plain version through both entries, B=2, T=2, float64, ``symmetrize``
on and off, against the JAX ``backward.riccati_step`` run eagerly, each
output within 1e-10 of its largest magnitude, as
``tests/test_torch_riccati_cluster.py`` holds ``(65, 32)`` and
``(72, 36)``.
"""

import pytest

from tests.test_torch_riccati_cluster import check_against_jax


@pytest.mark.parametrize("symmetrize", [True, False])
@pytest.mark.parametrize("n,m", [(20, 40)])
def test_plain_at_wide_cluster_shapes_matches_the_jax_step(n, m, symmetrize):
    check_against_jax(n, m, symmetrize)
