"""Scenario parallelism over the ranks of a ``torch.distributed`` group.

Counterpart of ``ilqr_tpu/parallel/mesh.py``.  Per-scenario solves are
independent, so the layout is pure data parallelism: the scenario batch is
cut into contiguous slices, one a rank, each rank solves its slice on its
own device, and only scalar metrics (converged count, cost sum, iteration
sum) cross ranks, in one ``all_reduce(SUM)`` a solve.

Where the JAX package has one program over a mesh of devices and global
arrays sharded over it (``shard_map`` over the ``scenarios`` axis), PyTorch
runs one process a device: a :class:`ScenarioMesh` is this rank's view of
the group (its rank, the world size and its device), and an array is the
rank's slice of the global batch.  :func:`shard_scenarios` cuts that slice
out of a global array; :func:`sharded_batch_solve` takes the slices and
returns this rank's result.

The group's backend follows the device: NCCL where the rank's device is a
CUDA card, Gloo on the CPU.  Nothing falls back: a missing process group
or a backend that cannot run raises, and the collective runs at every world
size, 1 included.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ilqr_tpu_torch.config import DEFAULT_CONFIG, ILQRConfig, Status
from ilqr_tpu_torch.parallel.batching import batch_solve
from ilqr_tpu_torch.problem import Problem

SCENARIO_AXIS = "scenarios"


@dataclasses.dataclass(frozen=True)
class ScenarioMesh:
    """A 1-D mesh over the ranks of a process group, one device a rank.

    ``group`` is the process group of the mesh's collectives (its backend
    suits ``device``), ``rank``/``size`` this rank's place in it and its
    size, ``axis`` the name of the mesh's one axis."""

    group: object
    rank: int
    size: int
    device: torch.device
    axis: str = SCENARIO_AXIS


def backend_for(device: torch.device) -> str:
    """The collective backend of a rank whose device is ``device``."""

    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def default_device(rank: int, device=None) -> torch.device:
    """The device of ``rank``: ``device`` where one is given, else the card
    of the rank's place on its host.  Raises when no card is present and no
    device was asked for, as ``precision.resolve_device`` does: there is no
    silent fall-back to the CPU."""

    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "ilqr_tpu_torch runs a rank on a CUDA device by default and none "
            "is available; pass devices=['cpu'] * world_size (a mesh) or "
            "device='cpu' (initialize_multihost) to run the ranks on the CPU "
            "with Gloo")
    return torch.device("cuda", rank % torch.cuda.device_count())


def make_rank_mesh(n_ranks: Optional[int], devices: Optional[Sequence],
                   axis: str) -> ScenarioMesh:
    """A mesh named ``axis`` over the ranks of the default process group
    (collective where it makes a group: every rank calls it).  ``devices`` gives each rank's device
    (``devices[rank]``); ``n_ranks`` must be the world size, since a torch
    process holds one device."""

    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: call parallel.distributed.initialize_multihost "
            "or torch.distributed.init_process_group first")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_ranks is not None and n_ranks != world:
        raise ValueError(
            f"a mesh of {n_ranks} devices needs {n_ranks} ranks (one device "
            f"a rank); the process group has {world}")
    if devices is not None and len(devices) < world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    device = default_device(rank, None if devices is None else devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = backend_for(device)
    # The default group where its backend suits the device, as it does when
    # initialize_multihost made it; a group of that backend otherwise.
    if backend in str(dist.get_backend()):
        group = dist.group.WORLD
    else:
        group = dist.new_group(ranks=list(range(world)), backend=backend)
    return ScenarioMesh(group=group, rank=rank, size=world, device=device,
                        axis=axis)


def make_scenario_mesh(n_devices: Optional[int] = None,
                       devices=None) -> ScenarioMesh:
    """A 1-D mesh over the ``scenarios`` axis: every rank of the default
    process group, one device a rank (``devices[rank]``, default: the rank's
    card; with no card, ``devices`` is required: ``["cpu"] * world_size``
    for Gloo ranks on the CPU).  Collective: every rank calls it."""

    return make_rank_mesh(n_devices, devices, SCENARIO_AXIS)


def _same_count(mesh: ScenarioMesh, count: int) -> None:
    """Raises unless every rank of ``mesh`` holds ``count`` scenarios (the
    global batch then divides evenly over the mesh)."""

    t = torch.tensor([count, -count], dtype=torch.int64, device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    most, least = int(t[0]), -int(t[1])
    if most != least:
        raise ValueError(
            f"the ranks hold between {least} and {most} scenarios: the "
            f"global batch must divide evenly over the mesh of {mesh.size}")


def sharded_batch_solve(problem: Problem, mesh: ScenarioMesh,
                        x0s: torch.Tensor, us0: torch.Tensor,
                        config: ILQRConfig = DEFAULT_CONFIG):
    """Solve a batch of scenarios sharded over the mesh.

    Every rank passes ITS slice of the global batch: ``x0s [b, n]``,
    ``us0 [b, T, m]``, the same ``b`` on every rank (the global ``B = b *
    mesh.size`` divides evenly: checked), for example from
    :func:`shard_scenarios`.  Each rank solves its slice on its device with
    ``batch_solve(engine="vmap")``, the per-scenario solver the JAX function
    runs, and returns ``(SolverResult of its slice, metrics)``.  The metrics
    are 0-d tensors summed over every rank by ``all_reduce(SUM)``, identical
    on every rank: ``n_converged``, ``mean_cost`` (the finite costs summed
    over the global batch, divided by ``B``) and ``total_iterations``.
    """

    b = x0s.shape[0]
    _same_count(mesh, b)
    result = batch_solve(problem, x0s, us0, config=config, engine="vmap",
                         device=mesh.device)
    counts = torch.stack([
        torch.sum((result.status == int(Status.CONVERGED)).to(torch.int64)),
        torch.sum(result.iterations.to(torch.int64))])
    total_cost = torch.sum(torch.where(torch.isfinite(result.cost),
                                       result.cost,
                                       torch.zeros_like(result.cost)))
    dist.all_reduce(counts, op=dist.ReduceOp.SUM, group=mesh.group)
    dist.all_reduce(total_cost, op=dist.ReduceOp.SUM, group=mesh.group)
    metrics = {
        "n_converged": counts[0],
        "mean_cost": total_cost / (b * mesh.size),
        "total_iterations": counts[1],
    }
    return result, metrics


def shard_scenarios(mesh: ScenarioMesh, *arrays):
    """This rank's contiguous slice of each global ``[B, ...]`` array, on
    the rank's device (``B`` must divide evenly over the mesh)."""

    out = []
    for a in arrays:
        B = a.shape[0]
        if B % mesh.size:
            raise ValueError(
                f"batch {B} not divisible by mesh size {mesh.size}")
        b = B // mesh.size
        out.append(a[mesh.rank * b:(mesh.rank + 1) * b].to(mesh.device))
    return tuple(out)
