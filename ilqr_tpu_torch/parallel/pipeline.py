"""Phase-pipelined solving over two ranks (pipeline parallelism).

Counterpart of ``ilqr_tpu/parallel/pipeline.py``: the two phases of one
iLQR iteration — the backward Riccati pass and the line-searched forward
rollout, the halves of :func:`ilqr_tpu_torch.step.ilqr_step` — run as
stages on two ranks, with scenario microbatches moving around the ring:

* stage 0 (rank 0) runs :func:`ilqr_tpu_torch.step.ilqr_step_backward` on
  its resident microbatch (derivatives and the Riccati recursion ->
  ``duffs, Ks, dV1, dV2``);
* stage 1 (rank 1) runs :func:`ilqr_tpu_torch.step.ilqr_step_apply`
  (stationarity gate, backtracking rollouts, convergence bookkeeping);
* after every tick the ranks swap their payloads (the microbatch's solver
  state and the backward outputs computed for it) by ``send``/``recv``,
  as the JAX ring does with ``lax.ppermute``.

With two microbatches in flight both stages are busy every tick after a
one-tick fill bubble, and each microbatch completes one solver iteration
per two ticks: the same iterates as the serial loop, because a
microbatch's forward phase at tick t+1 consumes exactly the backward
outputs computed for it at tick t.  As the JAX module says, scenario data
parallelism (:mod:`ilqr_tpu_torch.parallel.mesh`) does the same work with
no traffic between devices; this is here for completeness.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ilqr_tpu_torch.config import DEFAULT_CONFIG, ILQRConfig
from ilqr_tpu_torch.parallel.mesh import ScenarioMesh, make_rank_mesh
from ilqr_tpu_torch.precision import highest_precision
from ilqr_tpu_torch.problem import Problem
from ilqr_tpu_torch.solver import SolverResult
from ilqr_tpu_torch.step import (StepState, ilqr_step_apply,
                                 ilqr_step_backward, initial_state)

PIPELINE_AXIS = "pipeline"
N_STAGES = 2  # backward | forward: the two halves of ilqr_step


def make_pipeline_mesh(devices=None) -> ScenarioMesh:
    """A 2-rank mesh over the ``pipeline`` axis: the default process group,
    which must have exactly two ranks, one device a rank (``devices[rank]``,
    default: the rank's card, or the CPU).  Collective."""

    if not dist.is_initialized() or dist.get_world_size() != N_STAGES:
        raise ValueError(
            f"the pipeline needs {N_STAGES} ranks, have "
            f"{dist.get_world_size() if dist.is_initialized() else 1}")
    return make_rank_mesh(N_STAGES, devices, PIPELINE_AXIS)


def _rotate(mesh: ScenarioMesh, tensors):
    """Send this rank's payload to the next stage of the ring and take the
    previous stage's (with two stages, the ranks swap)."""

    nxt = (mesh.rank + 1) % N_STAGES
    prv = (mesh.rank - 1) % N_STAGES
    out = [torch.empty_like(t) for t in tensors]
    ops = ([dist.P2POp(dist.isend, t.contiguous(), nxt, mesh.group)
            for t in tensors]
           + [dist.P2POp(dist.irecv, o, prv, mesh.group) for o in out])
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


@highest_precision
def pipelined_solve(problem: Problem, mesh: ScenarioMesh, x0s: torch.Tensor,
                    us0: torch.Tensor,
                    config: ILQRConfig = DEFAULT_CONFIG) -> SolverResult:
    """Solve ``B`` scenarios as two microbatches streaming through the
    two-stage phase pipeline.

    Every rank passes the whole batch, ``x0s [B, n]``, ``us0 [B, T, m]``
    with ``B`` divisible by 2 (microbatch ``s`` starts on stage ``s``);
    every rank returns the batch-first :class:`SolverResult` of all ``B``
    in the caller's scenario order, on its device, equal to the fused
    single-device solve up to rounding.  Raises unless the mesh has two
    ranks.
    """

    from ilqr_tpu_torch.batched import (_result_from_state,
                                        make_batch_last_engine, rollout_bl)

    if mesh.size != N_STAGES:
        raise ValueError(f"the pipeline needs {N_STAGES} ranks, the mesh "
                         f"has {mesh.size}")
    B, T, m = us0.shape
    n = x0s.shape[1]
    if B % N_STAGES:
        raise ValueError(f"batch {B} not divisible by {N_STAGES}")
    mb = B // N_STAGES
    stage, device = mesh.rank, mesh.device
    lanes = slice(stage * mb, (stage + 1) * mb)
    x0_bl = x0s[lanes].to(device).movedim(0, -1).contiguous()   # [n, mb]
    us_bl = us0[lanes].to(device).movedim(0, -1).contiguous()   # [T, m, mb]
    dtype = x0_bl.dtype

    engine = make_batch_last_engine(problem, None, config)
    xs_bl = rollout_bl(problem, x0_bl, us_bl)
    state = initial_state(xs_bl, us_bl, config, lane_shape=(mb,))
    kw = dict(dtype=dtype, device=device)
    # The moving payload: solver state and the backward outputs produced
    # for it (zeros until its first pass through stage 0).
    payload = (state, torch.zeros((T, m, mb), **kw),
               torch.zeros((T, m, n, mb), **kw), torch.zeros((mb,), **kw),
               torch.zeros((mb,), **kw))

    def rotate(payload):
        flat = _rotate(mesh, list(payload[0]) + list(payload[1:]))
        return (StepState(*flat[:len(StepState._fields)]),
                *flat[len(StepState._fields):])

    n_ticks = N_STAGES * config.max_iter + 1   # +1: the fill bubble
    for tick in range(n_ticks):
        state, duffs, Ks, dV1, dV2 = payload
        if stage == 0:
            payload = (state, *ilqr_step_backward(engine, state))
        elif tick > 0:
            # At tick 0 the forward stage holds a microbatch whose backward
            # outputs are still the zero placeholders: applying them would
            # fake a du_sq=0 "converged" step, so it passes untouched.
            new_state = ilqr_step_apply(engine, config, state, duffs, Ks,
                                        dV1, dV2)[0]
            payload = (new_state, duffs, Ks, dV1, dV2)
        payload = rotate(payload)
    # Rotate the rest of the ring, so that each microbatch ends on the
    # stage it started on.
    for _ in range(-n_ticks % N_STAGES):
        payload = rotate(payload)

    local = _result_from_state(problem, payload[0], None)
    fields = []
    for x in local:
        parts = [torch.empty_like(x) for _ in range(N_STAGES)]
        dist.all_gather(parts, x.contiguous(), group=mesh.group)
        fields.append(torch.cat(parts, dim=0))
    return SolverResult(*fields)
