"""Scaling layer.  So far: batched solving of scenarios on one device, and
receding-horizon MPC of one scenario or a batch (also checkpointed in
chunks)."""

from ilqr_tpu_torch.parallel.batching import (batch_metrics, batch_solve,
                                              make_batch_solver)
from ilqr_tpu_torch.parallel.mpc import (MPCResult, batch_mpc_run,
                                         batch_mpc_run_chunked,
                                         make_mpc_runner, mpc_run)

__all__ = ["batch_metrics", "batch_solve", "make_batch_solver", "MPCResult",
           "batch_mpc_run", "batch_mpc_run_chunked", "make_mpc_runner",
           "mpc_run"]
