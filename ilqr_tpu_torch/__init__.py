"""ilqr_tpu_torch — the PyTorch/CUDA port of ``ilqr_tpu``.

A second package beside the JAX one, for one NVIDIA H100.  Same module
names, so a reader finds the counterpart of every function; plain functions
on ``torch`` tensors inside.  It imports ``torch`` and numpy, never ``jax``
and nothing of ``ilqr_tpu``.

Ported so far: the fused batch-last solve of a scenario batch
(``parallel.batching.make_batch_solver`` → ``batched.batched_solve_fused`` →
``step.ilqr_step``) on the analytic 2-link arm, and the chunked solve with
straggler compaction (``batched.make_chunked_batch_solver``) on the
floating-base arms of the rigid-body layer (``models.rbd``), with the
backward Riccati recursion in hand-written CUDA kernels
(``ops/cuda_riccati.py``, ``ops/csrc/``).  Entry points take an explicit
``device=`` and run on the card unless the caller asks for the CPU.
"""

from ilqr_tpu_torch.config import DEFAULT_CONFIG, ILQRConfig, Status
from ilqr_tpu_torch.problem import Problem, rollout, total_cost
from ilqr_tpu_torch.solver import SolverResult

__version__ = "0.1.0"

__all__ = [
    "DEFAULT_CONFIG",
    "ILQRConfig",
    "Status",
    "Problem",
    "rollout",
    "total_cost",
    "SolverResult",
]
