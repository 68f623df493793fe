"""Scaling layer: batched solving of scenarios on one device, receding-
horizon MPC of one scenario or a batch (also checkpointed in chunks), and
multi-device solving over the ranks of a ``torch.distributed`` group —
scenario data parallelism (``mesh``, ``distributed``) and the two-stage
phase pipeline (``pipeline``)."""

from ilqr_tpu_torch.parallel.batching import (batch_metrics, batch_solve,
                                              make_batch_solver)
from ilqr_tpu_torch.parallel.mesh import (make_scenario_mesh,
                                          shard_scenarios,
                                          sharded_batch_solve)
from ilqr_tpu_torch.parallel.mpc import (MPCResult, batch_mpc_run,
                                         batch_mpc_run_chunked,
                                         make_mpc_runner, mpc_run)
from ilqr_tpu_torch.parallel.pipeline import (make_pipeline_mesh,
                                              pipelined_solve)

__all__ = ["batch_metrics", "batch_solve", "make_batch_solver", "MPCResult",
           "batch_mpc_run", "batch_mpc_run_chunked", "make_mpc_runner",
           "mpc_run", "make_pipeline_mesh", "make_scenario_mesh",
           "pipelined_solve", "shard_scenarios", "sharded_batch_solve"]
