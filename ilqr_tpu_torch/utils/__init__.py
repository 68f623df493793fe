"""Observability, checkpointing and profiling."""

from ilqr_tpu_torch.utils.checkpoint import (load_solver_state,
                                             save_solver_state)
from ilqr_tpu_torch.utils.metrics import IterationTrace, solve_with_trace

__all__ = [
    "IterationTrace",
    "solve_with_trace",
    "save_solver_state",
    "load_solver_state",
]
