"""Scaling layer.  So far: batched solving of scenarios on one device."""

from ilqr_tpu_torch.parallel.batching import (batch_metrics, batch_solve,
                                              make_batch_solver)

__all__ = ["batch_metrics", "batch_solve", "make_batch_solver"]
