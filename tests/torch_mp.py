"""Multi-process helpers of the port's multi-device tests.

:func:`ranks_running` (or :func:`run_ranks`) starts one group of
processes on localhost, one a rank of a Gloo process group on the CPU, each
running a task of this module
(``python -m tests.torch_mp <task> <rank> <world> <port> <out_dir>``), and
waits for them, through the port's own launcher
(``ilqr_tpu_torch.parallel.distributed.local_ranks``): output to files, not
pipes (a worker that fills a pipe's buffer while the other waits for it in
a collective deadlocks the pair, ``tests/test_distributed.py``), at most
:data:`TIMEOUT_S` seconds a process, every process killed on a timeout or a
failure and the test failed with their output.  A task writes its results
to ``<out_dir>/rank<r>.npz`` for the test to compare.

The tasks import torch and the port only, never JAX.
"""

import contextlib
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 120.0

# tests/test_torch_mesh.py: the 2-link at B=8, T=16, float64.
MESH = dict(B=8, T=16, seed=11)
MESH_FLAGS = dict(max_iter=20, tol=1e-6, tol_grad=1e-10, tol_grad_rel=1e-6)
# tests/test_torch_pipeline.py: the two configs of tests/test_pipeline.py.
PIPE = dict(B=8, T=24, seed=3)
PIPE_FLAGS = (
    dict(max_iter=6, tol=1e-5, tol_grad=1e-10, tol_grad_rel=1e-6),
    dict(max_iter=6, tol=1e-5, tol_grad=1e-10, tol_grad_rel=1e-6,
         adaptive_reg=True, reg_backtrack_trigger=2),
)


def scenarios(B, T, seed):
    """``x0s [B, 4]`` around the swing-up's nominal start, zero ``us0``."""

    rng = np.random.default_rng(seed)
    x0s = np.array([0.3, 0.7, 0.2, 0.5]) + 0.1 * rng.standard_normal((B, 4))
    return x0s, np.zeros((B, T, 2))


@contextlib.contextmanager
def ranks_running(task: str, world: int, out_dir: Path):
    """Start ``task`` on ``world`` ranks (``parallel.distributed.
    local_ranks``: output to files, :data:`TIMEOUT_S` a process, none
    outliving the block); yields ``wait()``, which waits for them and
    returns each rank's npz contents.  The caller may work meanwhile."""

    from ilqr_tpu_torch.parallel.distributed import (free_local_port,
                                                     local_ranks)

    port = free_local_port()
    with local_ranks(lambda r: ["-m", "tests.torch_mp", task, str(r),
                                str(world), str(port), str(out_dir)],
                     world, TIMEOUT_S, cwd=str(ROOT)) as wait:
        def results():
            wait()
            return [dict(np.load(out_dir / f"rank{r}.npz"))
                    for r in range(world)]

        yield results


def run_ranks(task: str, world: int, out_dir: Path) -> list:
    """Run ``task`` on ``world`` ranks; returns each rank's npz contents."""

    with ranks_running(task, world, out_dir) as wait:
        return wait()


# ---------------------------------------------------------------------------
# The tasks, one a rank.
# ---------------------------------------------------------------------------

def _init(rank, world, port):
    import datetime

    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=60))


def task_mesh(rank, world, port):
    """``sharded_batch_solve`` of this rank's slice."""

    import torch
    import torch.distributed as dist

    from ilqr_tpu_torch.convert import config_from_fields
    from ilqr_tpu_torch.models.two_link import make_two_link_problem
    from ilqr_tpu_torch.parallel.mesh import (make_scenario_mesh,
                                              shard_scenarios,
                                              sharded_batch_solve)

    _init(rank, world, port)
    mesh = make_scenario_mesh(devices=["cpu"] * world)
    x0s, us0 = (torch.as_tensor(a) for a in scenarios(**MESH))
    x_loc, u_loc = shard_scenarios(mesh, x0s, us0)
    res, metrics = sharded_batch_solve(make_two_link_problem(), mesh, x_loc,
                                       u_loc,
                                       config=config_from_fields(MESH_FLAGS))
    out = {f: getattr(res, f).numpy() for f in res._fields}
    out.update({f"metric_{k}": v.numpy() for k, v in metrics.items()})
    out["rank"], out["size"], out["axis"] = rank, mesh.size, mesh.axis
    out["default_group"] = mesh.group == dist.group.WORLD
    return out


def task_pipeline(rank, world, port):
    """``pipelined_solve`` with each of the two configs."""

    import torch

    from ilqr_tpu_torch.convert import config_from_fields
    from ilqr_tpu_torch.models.two_link import make_two_link_problem
    from ilqr_tpu_torch.parallel.pipeline import (make_pipeline_mesh,
                                                  pipelined_solve)

    _init(rank, world, port)
    mesh = make_pipeline_mesh(devices=["cpu"] * world)
    x0s, us0 = (torch.as_tensor(a) for a in scenarios(**PIPE))
    out = {"axis": mesh.axis}
    for i, flags in enumerate(PIPE_FLAGS):
        res = pipelined_solve(make_two_link_problem(), mesh, x0s, us0,
                              config=config_from_fields(flags))
        out.update({f"{i}_{f}": getattr(res, f).numpy() for f in res._fields})
    return out


def task_distributed(rank, world, port):
    """The runtime helpers in a real group joined through
    ``initialize_multihost``."""

    import torch
    import torch.distributed as dist

    from ilqr_tpu_torch.parallel import distributed as d

    d.initialize_multihost(coordinator_address=f"127.0.0.1:{port}",
                           num_processes=world, process_id=rank,
                           initialization_timeout=60, device="cpu")
    mesh = d.global_scenario_mesh(devices=["cpu"] * world)
    draws = [torch.rand(4, generator=d.per_host_keys(seed)).numpy()
             for seed in (7, 7, 8)]
    local = torch.arange(4 * rank, 4 * rank + 4, dtype=torch.float64)
    mine = d.make_global_scenario_array(local.numpy(), mesh)
    try:   # ranks holding different counts: every rank raises
        d.make_global_scenario_array(local[:3 + rank], mesh)
        uneven = "accepted"
    except ValueError as e:
        uneven = str(e)
    return dict(world=dist.get_world_size(), rank=dist.get_rank(),
                mesh_size=mesh.size, backend=dist.get_backend(mesh.group),
                default_group=mesh.group == dist.group.WORLD,
                local_batch=d.host_local_batch(8), draws=np.stack(draws),
                mine=mine.numpy(), uneven=uneven)


if __name__ == "__main__":
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    task, rank, world, port, out_dir = sys.argv[1:6]
    rank, world = int(rank), int(world)
    try:
        result = globals()[f"task_{task}"](rank, world, int(port))
        np.savez(Path(out_dir) / f"rank{rank}.npz", **result)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
