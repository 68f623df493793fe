"""The free-flying five-arm (``models/rbd/assets/five_6Dof_arm.urdf``,
n=72, m=36) through the fused engine, float64, CPU.

One fused solve (``make_batch_solver(engine="fused")``, the path that
reaches the kernel's batch-last entry at ``(72, 36)``, in
``csrc/riccati_cluster.cu`` on the card; here its plain version) at B=2,
T=4, equal to the port's per-scenario ``solve`` of each lane: status and
iterations identical, every float field within rtol 1e-10 / atol 1e-12 (two
float64 programs whose sums run in another order), as
``tests/test_torch_al_6dof.py`` holds its two backends.  The model itself
is held against the JAX package in ``tests/test_torch_rbd_five.py``.
"""

import torch

from ilqr_tpu_torch.config import ILQRConfig
from ilqr_tpu_torch.parallel.batching import make_batch_solver
from ilqr_tpu_torch.problem import rollout
from ilqr_tpu_torch.solver import solve
from tests.test_torch_rbd_five import FLAGS, port_problem, x0s
from tests.torch_parity import to_torch

torch.set_num_threads(1)


def test_fused_solve_equals_the_per_scenario_solve():
    B, T = 2, 4
    problem = port_problem()
    x0 = to_torch(x0s(B, 72))
    us0 = torch.zeros((B, T, 36), dtype=torch.float64)
    config = ILQRConfig(**FLAGS)
    fused = make_batch_solver(problem, config, engine="fused",
                              device="cpu")(x0, us0)
    assert fused.us.shape == (B, T, 36) and fused.xs.shape == (B, T + 1, 72)
    assert int(fused.iterations.min()) >= 2
    for b in range(B):
        one = solve(problem, rollout(problem.dynamics, x0[b], us0[b]),
                    us0[b], config=config, device="cpu")
        for name, a, r in zip(one._fields, fused, one):
            if a.is_floating_point():
                torch.testing.assert_close(a[b], r, rtol=1e-10, atol=1e-12,
                                           msg=name)
            else:
                assert torch.equal(a[b], r), name
