"""Single-device batched solving of scenarios.

Thousands of perturbed initial states / MPC scenarios are solved together.
Each scenario carries its own line-search alpha, regularization, iteration
count and status flag — a diverged scenario is masked data, not a crash
(the reference instead asserts and dies on the first NaN,
src/forward_pass.jl:89-90).  Counterpart of
``ilqr_tpu/parallel/batching.py``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ilqr_tpu_torch.batched import batched_solve_fused, rollout_bl
from ilqr_tpu_torch.config import DEFAULT_CONFIG, ILQRConfig, Status
from ilqr_tpu_torch.precision import resolve_device
from ilqr_tpu_torch.problem import Problem
from ilqr_tpu_torch.solver import SolverResult, solve

ENGINES = ("fused", "vmap")


def batch_solve(problem: Problem, x0s: torch.Tensor, us0: torch.Tensor,
                x_refs: Optional[torch.Tensor] = None,
                config: ILQRConfig = DEFAULT_CONFIG,
                warm_xs: Optional[torch.Tensor] = None,
                engine: str = "fused", device=None) -> SolverResult:
    """Solve a batch of scenarios: ``x0s [B, n]``, ``us0 [B, T, m]``.

    Initial state trajectories are open-loop rollouts of ``us0`` from each
    ``x0`` (pass ``warm_xs [B, T+1, n]`` to override, e.g. for MPC warm
    starts).  Returns a ``SolverResult`` with a leading batch axis on every
    field, on ``device`` (default: the card).

    ``engine``:

    * ``"fused"`` (the port's default) — the batch-last engine
      (``ilqr_tpu_torch.batched``), with the fused CUDA Riccati kernel when
      ``config.backward_backend == "pallas"``;
    * ``"vmap"`` (the JAX package's default) — the per-scenario solver
      (:func:`ilqr_tpu_torch.solver.solve`) on the ``[B, ...]`` inputs, its
      ``jax.vmap`` written out as a leading batch axis; with ``"pallas"``
      its backward pass launches the kernel's batch-first entry.

    The two give the same results (the JAX package's
    ``tests/test_batched_fused.py``; here ``tests/test_torch_solver.py``).
    """

    if engine not in ENGINES:
        raise NotImplementedError(
            f"engine={engine!r} is not ported: ilqr_tpu_torch has {ENGINES}")

    device = resolve_device(device)
    x0s, us0 = x0s.to(device), us0.to(device)
    if warm_xs is None:
        warm_xs = rollout_bl(problem, x0s.movedim(0, -1),
                             us0.movedim(0, -1)).movedim(-1, 0)
    if engine == "vmap":
        return solve(problem, warm_xs, us0, x_refs, config, device=device)
    assert x_refs is None or x_refs.ndim == warm_xs.ndim
    return batched_solve_fused(problem, warm_xs, us0, x_refs, config,
                               device=device)


def make_batch_solver(problem: Problem, config: ILQRConfig = DEFAULT_CONFIG,
                      engine: str = "fused", device=None):
    """``(x0s, us0) -> SolverResult`` batched solver with ``engine`` (see
    :func:`batch_solve`) on ``device`` (default: the card).  Inputs may live
    anywhere; they are moved."""

    device = resolve_device(device)

    def solve_fn(x0s, us0):
        return batch_solve(problem, x0s, us0, config=config, engine=engine,
                           device=device)

    return solve_fn


def batch_metrics(result: SolverResult) -> dict:
    """Aggregate per-scenario results into scalar batch metrics."""

    converged = result.status == int(Status.CONVERGED)
    failed = result.status == int(Status.LINESEARCH_FAILED)
    finite = torch.isfinite(result.cost)
    return {
        "n_converged": torch.sum(converged.to(torch.int32)),
        "n_failed": torch.sum(failed.to(torch.int32)),
        "mean_iterations": torch.mean(result.iterations.to(torch.float32)),
        "mean_cost": torch.mean(torch.where(finite, result.cost, 0.0)),
        "max_cost": torch.max(torch.where(finite, result.cost,
                                          float("-inf"))),
    }
