"""Entry points: one solver iteration, and a multi-device dry run.

Counterpart of the JAX package's ``__graft_entry__.py``.

* :func:`entry` returns ``(fn, example_args)``: one per-scenario iLQR
  iteration (backward Riccati pass, then the line-searched rollout) on the
  2-link swing-up at T=32.
* :func:`dryrun_multichip` runs :func:`ilqr_tpu_torch.parallel.mesh.
  sharded_batch_solve` over ``n`` ranks, one process a rank on localhost
  (NCCL on cards, Gloo on the CPU), with the JAX dry run's two checks.

    python -m ilqr_tpu_torch.entry [--cpu]          # runs entry() once
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

# Seconds the dry run's processes may take, each.
DRYRUN_TIMEOUT_S = 120.0


def entry(device=None):
    """``(fn, example_args)``: ``fn(xs, us) -> (xs, us, cost)`` is one full
    solver iteration on the 2-link swing-up, ``example_args`` a float32
    trajectory of T=32 steps on ``device`` (default: the card)."""

    from ilqr_tpu_torch.backward import backward_pass
    from ilqr_tpu_torch.config import ILQRConfig
    from ilqr_tpu_torch.forward import forward_pass
    from ilqr_tpu_torch.models.two_link import make_two_link_problem
    from ilqr_tpu_torch.precision import resolve_device
    from ilqr_tpu_torch.problem import total_cost

    problem = make_two_link_problem()
    config = ILQRConfig()
    T = 32
    device = resolve_device(device)

    def step(xs, us):
        bwd = backward_pass(problem, xs, us, config)
        prev_cost = total_cost(problem, xs, us)
        fwd = forward_pass(problem, xs, us, bwd.duffs, bwd.Ks, prev_cost,
                           None, config)
        return fwd.xs, fwd.us, fwd.cost

    x0 = torch.tensor([0.3, 0.7, 0.2, 0.5], dtype=torch.float32,
                      device=device)
    xs = x0.repeat(T + 1, 1)
    us = torch.zeros((T, 2), dtype=torch.float32, device=device)
    return step, (xs, us)


def dryrun_multichip(n_devices: int, device=None,
                     timeout: float = DRYRUN_TIMEOUT_S) -> list:
    """Shard a batched solve over ``n_devices`` ranks and check it, as the
    JAX dry run does: ``n_devices`` processes on this machine, one device a
    rank (the cards with NCCL; with ``device="cpu"``, the CPU with Gloo),
    2 scenarios a rank, T=32, float32.

    1. A short run (``max_iter=2``) equals the single-process solve of the
       whole batch on the rank's device to rounding (rtol 1e-6), status for
       status, and the reduced converged count is the reference's.
    2. A production config (stationarity test, adaptive regularization) to
       convergence: ``us`` within 1e-3, statuses CONVERGED or MAX_ITER, at
       least half converged, and the reduced count equal to the gathered
       statuses'.

    Each process has ``timeout`` seconds; on a timeout or a failure every
    process is stopped and ``RuntimeError`` raised with the processes'
    output (:func:`ilqr_tpu_torch.parallel.distributed.local_ranks`).
    Returns each rank's summary (a dict).
    """

    from ilqr_tpu_torch.parallel.distributed import (free_local_port,
                                                     local_ranks)
    from ilqr_tpu_torch.precision import resolve_device

    device = resolve_device(device)
    if device.type == "cuda" and torch.cuda.device_count() < n_devices:
        raise ValueError(f"need {n_devices} cards, have "
                         f"{torch.cuda.device_count()}")
    port = free_local_port()
    root = Path(__file__).resolve().parents[1]
    with local_ranks(lambda r: ["-m", "ilqr_tpu_torch.entry", "--dryrun-rank",
                                str(r), str(n_devices), str(port),
                                device.type],
                     n_devices, timeout, cwd=str(root)) as wait:
        return [json.loads(out.splitlines()[-1]) for out in wait()]


def _dryrun_rank(rank: int, n: int, port: int, device_type: str) -> dict:
    """One rank of :func:`dryrun_multichip`."""

    import datetime

    import torch.distributed as dist

    from ilqr_tpu_torch.config import ILQRConfig
    from ilqr_tpu_torch.models.two_link import make_two_link_problem
    from ilqr_tpu_torch.parallel.batching import batch_solve
    from ilqr_tpu_torch.parallel.mesh import (backend_for,
                                              make_scenario_mesh,
                                              shard_scenarios,
                                              sharded_batch_solve)

    torch.set_num_threads(1)
    if device_type == "cuda":
        devices = [torch.device("cuda", r % torch.cuda.device_count())
                   for r in range(n)]
    else:
        devices = [torch.device("cpu")] * n
    dist.init_process_group(backend_for(devices[rank]),
                            init_method=f"tcp://127.0.0.1:{port}",
                            world_size=n, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_scenario_mesh(n_devices=n, devices=devices)
        problem = make_two_link_problem()
        T, batch = 32, 2 * n
        gen = torch.Generator().manual_seed(0)
        x0s = 0.1 * torch.randn((batch, 4), generator=gen,
                                dtype=torch.float32)
        us0 = torch.zeros((batch, T, 2), dtype=torch.float32)
        x_loc, u_loc = shard_scenarios(mesh, x0s, us0)
        mine = slice(2 * rank, 2 * rank + 2)

        # Check 1: a short run, sharded == unsharded to rounding.
        cfg_exact = ILQRConfig(max_iter=2)
        result, metrics = sharded_batch_solve(problem, mesh, x_loc, u_loc,
                                              config=cfg_exact)
        assert result.us.shape == (2, T, 2), result.us.shape
        assert metrics["n_converged"].shape == ()
        ref = batch_solve(problem, x0s, us0, config=cfg_exact, engine="vmap",
                          device=mesh.device)
        torch.testing.assert_close(result.us, ref.us[mine], rtol=1e-6,
                                   atol=1e-7)
        assert torch.equal(result.status, ref.status[mine])
        assert int(metrics["n_converged"]) == int((ref.status == 1).sum())

        # Check 2: a production config through the sharded path.
        cfg_prod = ILQRConfig(max_iter=10, tol=1e-5, tol_grad=1e-10,
                              tol_grad_rel=1e-6, adaptive_reg=True,
                              reg_backtrack_trigger=2)
        result2, metrics2 = sharded_batch_solve(problem, mesh, x_loc, u_loc,
                                                config=cfg_prod)
        ref2 = batch_solve(problem, x0s, us0, config=cfg_prod, engine="vmap",
                           device=mesh.device)
        torch.testing.assert_close(result2.us, ref2.us[mine], rtol=1e-3,
                                   atol=1e-4)
        parts = [torch.empty_like(result2.status) for _ in range(n)]
        dist.all_gather(parts, result2.status, group=mesh.group)
        status2 = torch.cat(parts)
        assert set(status2.tolist()) <= {1, 2}, status2
        assert int((status2 == 1).sum()) >= batch // 2, status2
        assert int(metrics2["n_converged"]) == int((status2 == 1).sum())
        return dict(rank=rank, world_size=n, backend=backend_for(mesh.device),
                    device=str(mesh.device),
                    n_converged=[int(metrics["n_converged"]),
                                 int(metrics2["n_converged"])],
                    mean_cost=float(metrics2["mean_cost"]),
                    total_iterations=int(metrics2["total_iterations"]),
                    us_max_abs_diff=float((result2.us - ref2.us[mine])
                                          .abs().max()))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dryrun-rank"]:
        rank, n, port = (int(v) for v in sys.argv[2:5])
        print(json.dumps(_dryrun_rank(rank, n, port, sys.argv[5])),
              flush=True)
    else:
        fn, args = entry(device="cpu" if "--cpu" in sys.argv else None)
        out = fn(*args)
        print("entry ok:", tuple(tuple(o.shape) for o in out))
