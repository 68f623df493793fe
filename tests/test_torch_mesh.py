"""Scenario parallelism of the port (``ilqr_tpu_torch.parallel.mesh``) on a
real process group: two Gloo ranks on localhost, float64, the 2-link at
B=8, T=16 (one group of processes for the whole file, ``tests/torch_mp.py``).

* The ranks' slices against the single-process ``batch_solve(engine=
  "vmap")`` of the whole batch: ``status`` and ``iterations`` equal, ``us``
  to rtol 1e-10.
* The metrics: equal on both ranks, and equal to the single-process sums
  (the counts exactly; the mean cost to rtol 1e-12, a sum of two partial
  sums against one sum of eight).
* Against JAX: ``ilqr_tpu.parallel.mesh.sharded_batch_solve`` on two of the
  conftest's virtual CPU devices, the same numpy inputs: ``us`` to rtol
  1e-10, the same statuses and metrics.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_tpu.config import ILQRConfig as JaxConfig
from ilqr_tpu.models.two_link import make_two_link_problem as jax_two_link
from ilqr_tpu.parallel.mesh import make_scenario_mesh as jax_mesh
from ilqr_tpu.parallel.mesh import sharded_batch_solve as jax_sharded
from ilqr_tpu_torch.convert import config_from_fields
from ilqr_tpu_torch.models.two_link import make_two_link_problem
from ilqr_tpu_torch.parallel import mesh as port_mesh
from ilqr_tpu_torch.parallel.batching import batch_solve
from tests.conftest import cpu_devices
from tests.torch_mp import MESH, MESH_FLAGS, ranks_running, scenarios

torch.set_num_threads(1)

FIELDS = ("us", "status", "iterations", "cost")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The ranks' results, the single-process solve and the JAX sharded
    solve; the references are computed while the ranks run."""

    x0s, us0 = scenarios(**MESH)
    with ranks_running("mesh", 2, tmp_path_factory.mktemp("mesh")) as wait:
        jax_res, jax_metrics = jax_sharded(
            jax_two_link(), jax_mesh(n_devices=2, devices=cpu_devices()),
            jnp.asarray(x0s), jnp.asarray(us0),
            config=JaxConfig(**MESH_FLAGS))
        single = batch_solve(make_two_link_problem(), torch.as_tensor(x0s),
                             torch.as_tensor(us0),
                             config=config_from_fields(MESH_FLAGS),
                             engine="vmap", device="cpu")
        return wait(), single, (jax_res, jax_metrics)


@pytest.fixture(scope="module")
def ranks(results):
    return results[0]


@pytest.fixture(scope="module")
def single(results):
    return results[1]


def gathered(ranks, field):
    return np.concatenate([r[field] for r in ranks])


def test_sharded_matches_single_process(ranks, single):
    assert [int(r["rank"]) for r in ranks] == [0, 1]
    assert all(int(r["size"]) == 2 and str(r["axis"]) == "scenarios"
               for r in ranks)
    # A Gloo default group suits the CPU: the mesh makes no second group.
    assert all(bool(r["default_group"]) for r in ranks)
    assert all(r["us"].shape == (MESH["B"] // 2, MESH["T"], 2)
               for r in ranks)
    np.testing.assert_array_equal(gathered(ranks, "status"),
                                  single.status.numpy())
    np.testing.assert_array_equal(gathered(ranks, "iterations"),
                                  single.iterations.numpy())
    np.testing.assert_allclose(gathered(ranks, "us"), single.us.numpy(),
                               rtol=1e-10, atol=1e-12)


def test_metrics_on_every_rank_are_the_sums(ranks, single):
    for name in ("n_converged", "mean_cost", "total_iterations"):
        assert ranks[0][f"metric_{name}"] == ranks[1][f"metric_{name}"]
    m = ranks[0]
    assert int(m["metric_n_converged"]) == int((single.status == 1).sum())
    assert int(m["metric_total_iterations"]) == int(single.iterations.sum())
    finite = torch.where(torch.isfinite(single.cost), single.cost, 0.0)
    np.testing.assert_allclose(m["metric_mean_cost"],
                               float(finite.sum()) / MESH["B"], rtol=1e-12)
    assert int(m["metric_n_converged"]) >= MESH["B"] // 2


def test_sharded_matches_jax(ranks, results):
    res, metrics = results[2]
    np.testing.assert_array_equal(gathered(ranks, "status"),
                                  np.asarray(res.status))
    np.testing.assert_array_equal(gathered(ranks, "iterations"),
                                  np.asarray(res.iterations))
    np.testing.assert_allclose(gathered(ranks, "us"), np.asarray(res.us),
                               rtol=1e-10, atol=1e-12)
    m = ranks[0]
    assert int(m["metric_n_converged"]) == int(metrics["n_converged"])
    assert (int(m["metric_total_iterations"])
            == int(metrics["total_iterations"]))
    np.testing.assert_allclose(m["metric_mean_cost"],
                               float(metrics["mean_cost"]), rtol=1e-10)


def test_shard_scenarios_cuts_contiguous_slices():
    x = torch.arange(12.0).reshape(6, 2)
    for rank in range(3):
        mesh = port_mesh.ScenarioMesh(group=None, rank=rank, size=3,
                                      device=torch.device("cpu"))
        (part,) = port_mesh.shard_scenarios(mesh, x)
        assert torch.equal(part, x[2 * rank:2 * rank + 2])
    mesh = port_mesh.ScenarioMesh(group=None, rank=0, size=4,
                                  device=torch.device("cpu"))
    with pytest.raises(ValueError, match="divisible"):
        port_mesh.shard_scenarios(mesh, x)
    assert mesh.axis == port_mesh.SCENARIO_AXIS == "scenarios"
    assert port_mesh.backend_for(torch.device("cpu")) == "gloo"
    assert port_mesh.backend_for(torch.device("cuda", 0)) == "nccl"


def test_a_mesh_needs_a_process_group():
    import torch.distributed as dist

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        port_mesh.make_scenario_mesh()


def test_no_card_and_no_devices_raises_on_a_gloo_group(monkeypatch):
    import torch.distributed as dist

    from ilqr_tpu_torch.parallel.distributed import free_local_port

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert not dist.is_initialized()
    dist.init_process_group("gloo",
                            init_method=f"tcp://127.0.0.1:{free_local_port()}",
                            world_size=1, rank=0)
    try:
        # No silent fall-back to the CPU: the caller names it.
        with pytest.raises(RuntimeError, match=r"devices=\['cpu'\]"):
            port_mesh.make_scenario_mesh()
        mesh = port_mesh.make_scenario_mesh(devices=["cpu"])
        assert mesh.device == torch.device("cpu") and mesh.size == 1
        assert dist.get_backend(mesh.group) == "gloo"
    finally:
        dist.destroy_process_group()
