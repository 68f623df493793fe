"""Multi-process runtime helpers.

Counterpart of ``ilqr_tpu/parallel/distributed.py``.  The JAX module wraps
JAX's multi-controller runtime (one process a host, ``jax.distributed``);
the port runs one process a device under ``torch.distributed``: a process
group whose ranks form the global scenario mesh, a random generator a rank
for scenario sampling, and each rank's share of the global batch.  Global
reductions happen in :func:`ilqr_tpu_torch.parallel.mesh.
sharded_batch_solve`.

Nothing here reaches beyond the addresses the caller gives or the
launcher's environment names: ``torchrun`` sets ``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``; otherwise pass a coordinator
``host:port`` (``localhost`` for processes of one machine).
"""

from __future__ import annotations

import contextlib
import datetime
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ilqr_tpu_torch.parallel.mesh import (ScenarioMesh, _same_count,
                                          backend_for, default_device,
                                          make_scenario_mesh)

# The variables torchrun (and torch.distributed's env:// rendezvous) read.
LAUNCHER_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         initialization_timeout: Optional[int] = None,
                         device=None) -> None:
    """Initialize the default process group (a no-op for one process).

    With ``coordinator_address`` (``host:port``, rank 0 listens there) the
    group is joined at ``tcp://coordinator_address`` as rank ``process_id``
    of ``num_processes``; without it, at ``env://`` when a launcher's
    variables (:data:`LAUNCHER_ENV`) are set.  The backend is the one of the
    rank's device (``mesh.backend_for(mesh.default_device(rank, device))``):
    NCCL on the rank's card by default, Gloo with ``device="cpu"``; with no
    card and no ``device`` it raises, before any rendezvous (no silent
    fall-back to the CPU).  The scenario mesh then runs its collectives on
    this group.  ``initialization_timeout`` (seconds) bounds the rendezvous
    and later collectives.

    Failure policy, the JAX package's: ``num_processes <= 1`` does nothing;
    when the caller asked for a multi-process run (a coordinator address or
    ``num_processes > 1``) a failure RAISES — running one process would
    "succeed" the job with 1/N of the work.  Only the fully automatic path
    (no arguments) with no cluster found stays single-process, and it warns.
    """

    if num_processes is not None and num_processes <= 1:
        return
    if coordinator_address is None and dist.is_initialized():
        return  # already initialized by the launcher

    kwargs = {}
    if initialization_timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=initialization_timeout)
    if coordinator_address is not None:
        # Explicit cluster spec: never swallow a failure (an unreachable
        # coordinator raises out of here once the timeout passes).
        if num_processes is None or process_id is None:
            raise ValueError(
                "initialize_multihost: a coordinator_address needs "
                "num_processes and process_id")
        dist.init_process_group(
            backend_for(default_device(process_id, device)),
            init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id, **kwargs)
        return

    try:
        missing = [v for v in LAUNCHER_ENV if v not in os.environ]
        if missing:
            raise RuntimeError(f"no cluster found: {missing} not set")
        rank = int(os.environ["RANK"])
    except (RuntimeError, ValueError) as e:
        _stay_single_process(e, num_processes)
        return
    # Outside the fall-back: no card and no device raises whatever the
    # cluster.
    backend = backend_for(default_device(rank, device))
    try:
        dist.init_process_group(backend, init_method="env://", **kwargs)
    except (RuntimeError, ValueError) as e:
        _stay_single_process(e, num_processes)


def _stay_single_process(error, num_processes) -> None:
    """No cluster found on the automatic path: raise where the caller asked
    for several processes, else warn and stay single-process."""

    if num_processes is not None and num_processes > 1:
        raise RuntimeError(
            f"multi-process initialization failed for num_processes="
            f"{num_processes}; refusing to silently run single-process"
        ) from error
    import warnings

    warnings.warn(
        "torch.distributed initialization found no cluster; continuing "
        f"single-process: {error!r}", stacklevel=3)


def global_scenario_mesh(devices=None) -> ScenarioMesh:
    """A 1-D mesh over every rank of the process group, one device a rank
    (``devices[rank]``, default the rank's card; collective: every rank
    calls it)."""

    return make_scenario_mesh(devices=devices)


def _world() -> tuple:
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def host_local_batch(global_batch: int) -> int:
    """Scenarios this rank is responsible for (the global batch must divide
    evenly over the ranks)."""

    n = _world()[1]
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} does not divide over "
                         f"{n} ranks")
    return global_batch // n


def per_host_keys(seed: int, device="cpu") -> torch.Generator:
    """A random generator unique to this rank, for rank-local scenario
    sampling: seeded from ``(seed, rank)`` through numpy's ``SeedSequence``,
    so that it is distinct for every rank and the same in every run.  (JAX's
    ``fold_in`` bits are not reproduced: the two frameworks draw different
    numbers from one seed anyway.)"""

    rank = _world()[0]
    state = np.random.SeedSequence([seed, rank]).generate_state(1, np.uint64)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state[0]) & 0x7FFF_FFFF_FFFF_FFFF)
    return gen


def make_global_scenario_array(local_values, mesh: ScenarioMesh):
    """This rank's part of a scenario array sharded over ``mesh``: each rank
    passes ONLY its own lanes ``[b, ...]`` (the JAX package's test passed
    the whole batch from every process, ``ROADMAP.md`` C7), and every rank
    must hold the same ``b`` (checked, a collective).  Returns the lanes on
    the rank's device: PyTorch has no global array, and the sharded solve
    takes each rank's slice."""

    local = torch.as_tensor(local_values)
    _same_count(mesh, local.shape[0])
    return local.to(mesh.device)


def free_local_port() -> int:
    """A TCP port on 127.0.0.1 that nothing listens on now (for a
    coordinator or a ``TCPStore`` of processes on this machine)."""

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def local_ranks(argv: Callable[[int], List[str]], world: int,
                timeout: float, cwd: Optional[str] = None):
    """Start ``world`` processes on this machine, rank ``r`` running
    ``python *argv(r)``; yields ``wait()``, which waits for them and returns
    each rank's standard output.  The caller may work meanwhile.

    Their output goes to files, not pipes: a process that fills a pipe's
    buffer while another waits for it in a collective deadlocks the group.
    Each process has ``timeout`` seconds from the start; ``wait()`` raises
    ``RuntimeError`` with every rank's output on a timeout or an exit code
    other than 0, and no process outlives the block."""

    with tempfile.TemporaryDirectory() as td:
        logs = [(open(os.path.join(td, f"out{r}"), "w+"),
                 open(os.path.join(td, f"err{r}"), "w+"))
                for r in range(world)]
        deadline = time.monotonic() + timeout
        procs = []
        try:
            for r, (out, err) in enumerate(logs):
                procs.append(subprocess.Popen(
                    [sys.executable, *argv(r)], cwd=cwd, stdout=out,
                    stderr=err))

            def read(f):
                f.flush()
                f.seek(0)
                return f.read()

            def report(what):
                return what + "".join(
                    f"\n--- rank {r} stdout:\n{read(out)}"
                    f"\n--- rank {r} stderr:\n{read(err)[-3000:]}"
                    for r, (out, err) in enumerate(logs))

            def wait():
                for p in procs:
                    try:
                        p.wait(timeout=max(deadline - time.monotonic(), 1.0))
                    except subprocess.TimeoutExpired:
                        raise RuntimeError(report(
                            f"a rank ran past {timeout} s")) from None
                codes = [p.returncode for p in procs]
                if codes != [0] * world:
                    raise RuntimeError(report(f"exit codes {codes}"))
                return [read(out) for out, _ in logs]

            yield wait
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for out, err in logs:
                out.close()
                err.close()
