"""Scaling layer.  So far: batched solving of scenarios on one device, and
receding-horizon MPC of one scenario or a batch."""

from ilqr_tpu_torch.parallel.batching import (batch_metrics, batch_solve,
                                              make_batch_solver)
from ilqr_tpu_torch.parallel.mpc import (MPCResult, batch_mpc_run,
                                         make_mpc_runner, mpc_run)

__all__ = ["batch_metrics", "batch_solve", "make_batch_solver", "MPCResult",
           "batch_mpc_run", "make_mpc_runner", "mpc_run"]
