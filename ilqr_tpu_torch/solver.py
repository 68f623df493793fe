"""Solver results.  Counterpart of ``ilqr_tpu/solver.py``; of that module
only :class:`SolverResult` is here so far — the per-scenario solve loop
(``solve``, ``make_solver``, ``fit``) is not ported yet."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ilqr_tpu_torch.config import Status


class SolverResult(NamedTuple):
    xs: torch.Tensor          # [T+1, n] solution state trajectory
    us: torch.Tensor          # [T, m] solution controls
    cost: torch.Tensor        # scalar: cost of (xs, us)
    iterations: torch.Tensor  # int32: backward/forward iterations performed
    status: torch.Tensor      # int32: ilqr_tpu_torch.Status value
    reg: torch.Tensor         # final regularization (== config.reg unless adaptive)
    alpha: torch.Tensor       # last accepted step size
    du_sq: torch.Tensor       # last sum((u_new - u)^2) (convergence quantity)

    @property
    def converged(self):
        return self.status == int(Status.CONVERGED)
