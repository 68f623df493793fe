"""ilqr_tpu_torch — the PyTorch/CUDA port of ``ilqr_tpu``.

A second package beside the JAX one, for one NVIDIA H100.  Same module
names, so a reader finds the counterpart of every function; plain functions
on ``torch`` tensors inside.  It imports ``torch`` and numpy, never ``jax``
and nothing of ``ilqr_tpu``.

Ported: the fused batch-last solve of a scenario batch
(``parallel.batching.make_batch_solver`` → ``batched.batched_solve_fused`` →
``step.ilqr_step``) on the analytic 2-link arm, with the parallel-alpha
ladder; the chunked solve with straggler compaction, host snapshots, resume
and retry (``batched.make_chunked_batch_solver``, ``utils.checkpoint``) on
the floating-base arms of the rigid-body layer (``models.rbd``); the
per-scenario solver (``solver.solve``/``fit`` over ``derivatives``,
``backward`` — with the parallel-in-time ``pit`` — and ``forward``), which
takes leading batch axes and so also serves ``batch_solve(engine="vmap")``,
MPC (``parallel.mpc``, also checkpointed in chunks) and the
augmented-Lagrangian constraints (``al``, ``constraints``, ``costs``); the
iteration trace and profiling hooks (``utils``).  The backward Riccati
recursion runs in hand-written CUDA kernels (``ops/cuda_riccati.py``,
``ops/csrc/``) behind a batch-last and a batch-first entry.  Entry points
take an explicit ``device=`` and run on the card unless the caller asks
for the CPU.
"""

from ilqr_tpu_torch.backward import backward_pass
from ilqr_tpu_torch.config import DEFAULT_CONFIG, ILQRConfig, Status
from ilqr_tpu_torch.derivatives import (dynamics_hessians, linearize_dynamics,
                                        quadratize_final_cost,
                                        quadratize_running_cost)
from ilqr_tpu_torch.forward import forward_pass
from ilqr_tpu_torch.problem import Problem, rollout, total_cost
from ilqr_tpu_torch.solver import SolverResult, fit, make_solver, solve

__version__ = "0.1.0"

__all__ = [
    "DEFAULT_CONFIG",
    "ILQRConfig",
    "Status",
    "Problem",
    "rollout",
    "total_cost",
    "linearize_dynamics",
    "quadratize_running_cost",
    "quadratize_final_cost",
    "dynamics_hessians",
    "backward_pass",
    "forward_pass",
    "solve",
    "fit",
    "SolverResult",
    "make_solver",
]
