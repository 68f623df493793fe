#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --hashes [ROOT]   # only the fixed instantiations'
                                            # output hashes (of the port in ROOT)
    python3 chip_smoke.py --large-times [ROOT]   # only riccati_large.cu's
                                            # device times (of the port in ROOT)
    python3 chip_smoke.py --xl-times [ROOT]   # only riccati_xl.cu's device
                                            # times and stage clocks (ditto)
    python3 chip_smoke.py --cluster-times [ROOT]   # the same for
                                            # riccati_cluster.cu (ditto)

Needs one CUDA card (written for an H100, ``sm_90a``) and ``nvcc``; with no
card it exits non-zero and prints no result.  It imports nothing of JAX and
nothing of the JAX package.  Nothing falls back and nothing is swallowed:
any phase that fails ends the script with a traceback and a non-zero code.

Phases, one JSON line each:

1. ``device``   the card as ``nvidia-smi`` names it, torch and CUDA versions.
2. ``build``    ``nvcc`` builds ``ilqr_tpu_torch/ops/csrc/*.cu`` from the
                checkout: the two sources with fixed instantiations, each
                also with ``-DRICCATI_STAGE_CLOCKS`` (one ``nvcc`` a
                library, all at once, seconds); registers per kernel from
                ``ptxas``.  The instantiations of ``shapes`` (and their
                stage-clock builds) are built meanwhile by a process of its
                own at the lowest priority, while the phases that launch
                none of them run; ``build_instances`` waits for it before
                the first phase that does, and reports their ``nvcc``
                seconds and registers.
3. ``kernels``  the one-thread-a-lane Riccati kernel, ``(n, m) = (4, 2)``,
                against its plain PyTorch version on
                the card, on local models from ``derivatives_bl`` at a rolled
                out iterate: float64 at B=256, T=24 (rtol 1e-10), float32 and
                float64 at the main path's B=4096, T=100, float32 at a ragged
                B=4099, ``symmetrize`` on and off, scalar and per-lane
                ``reg``; then the kernel's time beside its bound and the
                plain version's time, and the float32 kernel's cycles a
                step by stage (the stage-clock build).
4. ``parity``   a small float64 solve on the card (kernel) against the same
                solve on the CPU (plain version): same status and
                iterations, ``us`` to rtol 1e-8.
5. ``solve``    the first main path: ``make_batch_solver(problem, config,
                engine="fused")`` on 4096 perturbed 2-link swing-ups, T=100,
                float32, ``backward_backend="pallas"`` (the CUDA kernel).
                The kernel's launch count is set to 0 before and read after:
                it must equal the passes of the solve.  A short float64
                solve drives the float64 instantiation the same way.  Then
                the same float32 inputs through ``backward_backend="scan"``
                for comparison, one more solve timed phase by phase, and
                the same solve through ``make_chunked_batch_solver`` with
                ``compact_sizes`` that fire: the straggler compaction
                (``index_select`` and the indexed write-back on the card)
                must have happened and must change no lane's result.
6. ``rbd_kernels``  the lane-spread kernel at ``(n, m) = (16, 8)`` and
                ``(24, 12)`` against the plain version, on local models of
                the floating-base arms: float64 at B=64, T=24 (rtol 1e-10,
                ``symmetrize`` on and off, scalar and per-lane ``reg``) and
                at the ragged B=257 and B=67 and float32 at B=65 (these take
                the kernel's per-element copy path, the others TMA; the
                path of each check is printed); float32 and float64 at the
                second main path's B=256, T=1000 (the local models of a
                T=100 iterate tiled ten times) and B=64, T=50 for the 6-DoF
                arm, float32 also against a float64 run of the same
                inputs; then the times (also at the cut solve's T=100), the
                ``(16, 8)`` float32 cycles a step by stage, and one whole
                pass at the cut solve's T=100 from a rolled-out iterate:
                ``derivatives_bl``, the kernel, and a ``forward_pass_bl``
                whose ladder is capped at three rungs.
7. ``rbd_solve``    the second main path, what ``bench.py --config rbd`` runs
                in the JAX package: the floating-base 2-DoF arm (n=16, m=8),
                B=256, float32, Tassa regularization, through
                ``make_chunked_batch_solver`` (``iter_chunk=10``,
                ``compact_sizes=(128,)``, host snapshots every 4 chunks as
                ``bench.py`` takes them) with the ``(16, 8)`` kernel.  The
                solve runs at the reference's T=1000 if five passes (ten
                times the pass timed at T=100) fit the budget, else at T=100
                with ``max_iter=2`` (printed), and stops at a chunk boundary once half the
                budget is spent.  Counts are set to 0 before and read after;
                then the same passes with ``backward_backend="scan"``.  The
                two backends are held to each other after ONE pass from the
                same state (1e-4 of max|us|, same alpha on every lane); after
                the cut solve, where its passes have amplified the rounding,
                the median lane and the cost are held and the worst lane is
                reported.
8. ``rbd_parity``   a float64 RBD solve on the card (kernel) against the CPU
                (plain version): B=8, T=24, a few passes.
9. ``rbd_6dof``     the 6-DoF arm on a floating base (n=24, m=12), B=64, T=50,
                float32, ``make_batch_solver(engine="fused")`` with the
                ``(24, 12)`` kernel (``max_iter=15``, fewer if the first
                pass says that would not fit the budget, at least 1; the cut
                printed), then a 1-pass
                float64 solve and the scan backend, held as in ``rbd_solve``
                (one pass tightly, the cut solve by median lane and cost).
10. ``rbd_dual``     the free-flying dual arm (two 6-DoF arms on one
                floating base, n=36, m=18), B=64, T=50, float32,
                ``make_batch_solver(engine="fused")`` with the ``(36, 18)``
                kernel in ``riccati_xl.cu``: the kernel against its plain
                version on the arm's local models and timed beside its
                bound, then the solve (``max_iter`` cut from 15 by its
                40 s budget, printed; the launches set to 0 before and read
                after) and its scan twin: status equal on every lane, the
                median and worst lane of ``us`` and the worst cost within
                the 6-DoF bars.
10b. ``rbd_five``   the same for the free-flying five-arm (five 6-DoF arms
                on one floating base, n=72, m=36): the ``(72, 36)`` kernel
                in ``riccati_cluster.cu``, a cluster of blocks a lane (its
                blocks a lane and the clusters resident printed), at the
                dual arm's B, T and budget.
11. ``batched_entry``  the kernel's batch-first entry
                ``riccati_scan_cuda_batched`` at every instantiation ((4, 2)
                B=4096 T=100, (16, 8) B=256 T=100, (24, 12) B=64 T=50, both
                types): equal (``torch.equal``) to the batch-last entry on
                the transposed inputs, within the bounds above of the plain
                version, contiguous outputs, no device memory allocated
                beyond them; then the entry's time beside the batch-last
                kernel's (there is no layout copy left to time).  Then the
                wide kernel's batch-first read at ragged batches, T=24, both
                types: (24, 12) B=67 and (16, 8) B=65 on TMA (the last box
                runs past B), (16, 8) B=1 on the per-element path, held the
                same way (float64 elementwise), each launch's copy path
                printed as its library reports it.
12. ``vmap_solve``  the third path: the per-scenario solver on a leading
                batch axis, ``make_batch_solver(engine="vmap")``, at phase
                ``solve``'s width and config; the batch-first launches are
                set to 0 before and read after (one a pass); held against
                the fused solve of phase ``solve``, timed phase by phase,
                and in float64 at B=8, T=24 card against CPU.
13. ``single``  one scenario, no batch axis: the float64 ``solve`` of the
                oracle's golden ``tests/fixtures/two_link_T100.npz`` on the
                card (``|u - u_ref|_inf < 1e-6``, the same iterations and
                cost), and the latency of one float32 solve at T=100.
14. ``mpc``, ``mpc_batch``  ``mpc_run`` (one scenario, H=50) and
                ``batch_mpc_run`` (B=1024, H=50, with the kernel, so every
                iteration of every replan launches the batch-first entry);
                ``n_steps`` cut from 50 to MPC_BUDGET_S, the cut printed.
15. ``resilience``  phase ``solve``'s chunked solve (``iter_chunk=2``)
                against itself retried after a ``torch.AcceleratorError``
                injected before chunk 2 (``snapshot_every=1``) and resumed by
                a fresh solver from the ``snapshot_path`` file a kill before
                chunk 2 left: ``torch.equal`` in ``us``, ``status`` and
                ``iterations``, the file gone after; again with compaction.
                (``rbd_solve`` runs ``bench.py``'s ``snapshot_every=4``.)
16. ``mpc_chunked``  ``batch_mpc_run_chunked`` (B=1024, H=50, the kernel),
                ``n_steps`` cut to a budget, stopped after the first chunk
                and resumed from its checkpoint: equal to ``batch_mpc_run``.
17. ``long_horizon``  ``bench.py --config long_horizon`` (B=256, T=1000)
                through ``engine="vmap"`` with ``scan``, ``pallas`` and
                ``associative``, ``max_iter`` cut to a budget; the float64
                associative backward pass (B=8, T=200) card against CPU.
18. ``parallel_alpha``  phase ``solve``'s fused solve with
                ``parallel_alpha_block`` 4 and 8: the sequential ladder's
                status, iterations and alpha on every lane, ``us`` equal
                (or within 1e-6 of max|us|); ladder seconds and rungs a pass.
19. ``al``      ``al_solve`` of the 2-link in a control box with a velocity
                cap (B=1024, T=50 cut from 100, float32, the kernel at
                ``(5, 2)``: the state carries the step index); the largest
                violation at or
                below the target; float64 B=4 card against CPU; the
                ``(5, 2)`` kernel against its plain version, timed.
20. ``trace_profile``  ``solve_with_trace`` of one float64 scenario, one
                fused pass under ``device_trace`` (the trace names the
                Riccati kernel) and ``PhaseTimer``'s summary.
21. ``shapes``  the kernel at shapes built at first use (``build`` also
                starts their ``nvcc``, one library a shape and type):
                ``(17, 8)`` (padded to (24, 8) in ``riccati_wide.cu``), and
                check-only rows that no path launches: ``(7, 3)`` (padded
                to (8, 4)), ``(6, 11)`` (more controls than states, padded
                to (8, 12)), ``(3, 1)`` and ``(5, 5)`` (``riccati.cu``);
                past the padded (24, 12), in ``riccati_large.cu``:
                ``(25, 12)`` (launched by ``al_6dof``), ``(32, 16)`` (its
                ceiling), ``(29, 5)`` and ``(10, 13)`` (more controls than
                states); past ``(32, 16)``, in ``riccati_xl.cu``: ``(36,
                18)`` (launched by ``rbd_dual``) and ``(64, 32)`` (its
                ceiling) in both types, ``(37, 18)``, ``(33, 16)`` and
                ``(20, 32)`` in float32; past ``(64, 32)``, in
                ``riccati_cluster.cu``: ``(72, 36)`` (launched by
                ``rbd_five``) and ``(128, 64)`` (its ceiling) in both types,
                ``(65, 32)``, ``(73, 36)``, ``(20, 40)`` and ``(96, 48)`` in
                float32 (the blocks a lane and the clusters resident
                printed); both entries, seeded
                inputs at B=256, T=100 (T=25 where m >= 32), against the plain version at the
                bars of ``kernels`` (float64 also with ``symmetrize`` off,
                on the last 10 steps); time, bound, plain time, padded plan and
                the bytes the source reports, registers and spills, copy
                path, nvcc seconds, and for ``riccati_large.cu`` and
                ``riccati_xl.cu`` the blocks resident on an SM and the
                cycles a step by stage of their float32 rows (their
                stage-clock builds; ``riccati_large.cu``'s float64 ones are
                in ``--large-times``).  Then a sha256 of the outputs of
                every fixed instantiation and of ``riccati_large.cu`` at
                ``(25, 12)`` and ``(32, 16)`` on seeded inputs
                (:func:`instantiation_hashes`, which runs on an older tree
                of the port too: equal hashes show their bits did not
                move).
22. ``al_rbd``  ``al_solve`` of the RBD 2-DoF arm with a joint-velocity cap
                (n=17 with the index, m=8), B=64, T=50, float32, the kernel
                at ``(17, 8)``, inner solves of 1 pass (cut from 5,
                printed), ``max_outer`` cut to a budget (printed),
                against the same call with ``"scan"``; the ``(17, 8)``
                kernel against its plain version on the local models of its
                first launch, timed.
23. ``al_6dof``  the same for the 6-DoF arm (n=25 with the index, m=12),
                B=64, T=50, float32: the kernel at ``(25, 12)``, in
                ``riccati_large.cu``.
24. ``sharded``  ``sharded_batch_solve`` on a world-size-1 NCCL group at the
                main path's width (B=4096, T=100, float32, the kernel):
                ``torch.equal`` to ``make_batch_solver(engine="vmap")``, the
                reduced metrics equal to ``batch_metrics``' sums.
25. ``entry``   ``entry.entry()`` once on the card and
                ``entry.dryrun_multichip(1)`` (one NCCL rank, a process of
                its own); then one ``pipeline`` line saying the two-stage
                pipeline is not run here (one card; it needs two ranks).
26. ``examples``  ``examples/torch_two_link_open_loop.py``,
                ``torch_two_link_swingup.py`` and ``torch_rbd_arm.py``, each
                ``main`` at a small ``--steps`` on the card: their printed
                lines, finite results on the card.
27. ``strict``  ``bench.py --config strict``: phase ``solve``'s width
                through the fused engine and the kernel with the reference's
                stopping rule (``tol=1e-6``, no gradient test, at most 100
                passes) and ``exact_ls_delta``: launches equal passes,
                lanes by status and mean iterations beside the TPU log's;
                the scan backend on the same inputs (status equal on every
                lane, ``us`` as phase ``solve`` holds it); float64 B=8,
                T=24 card against CPU.
28. ``rbd_ls``  ``bench.py --config rbd --ls-warm --ls-expected --ls-c
                0.4``: ``rbd_solve``'s chunked solve (T cut to 100) with
                the warm-started ladder and the expected-decrease test, the
                ``(16, 8)`` kernel; one and two passes against the scan
                backend (``us`` after one, the same alpha on every lane
                after each: the second ladder starts from the carried
                alpha), ``max_iter`` cut to a budget (printed; at 2 the
                two-pass run is the solve), launches equal passes; float64
                B=8, T=24, 2 passes in chunks of 1, card against CPU.
29. ``mpc_batch_rbd``  ``bench.py --config mpc_batch --problem rbd``:
                ``batch_mpc_run`` of 64 RBD arms, H=50, Tassa reg, with
                ``"scan"`` (as ``bench.py``) and then ``"pallas"``, whose
                every iteration launches the batch-first ``(16, 8)``
                entry; one pass of the first replan through both backends
                held tightly, its time cutting the replans' ``max_iter``
                and ``n_steps`` to a budget (printed); launches equal
                passes, the runs' statuses, median lane and costs against
                the scan run; ms a replan and scenario-replans/s; float64
                B=2, H=10, 2 steps, card against CPU.
30. ``ddp``     ``scripts/bench_ddp.py``'s rows (``ilqr``, ``ddp``,
                ``ddp+areg``, ``ilqr+areg``): the 2-link, B=64, T=50 (cut
                from 100, printed), float32, ``engine="vmap"`` with the scan backend (DDP takes
                ``dynamics_hessians`` into the recursion): converged, mean
                and max iterations, mean cost and seconds beside the TPU
                log's; float64 B=8, T=24 with ``ddp`` and ``reg_in_value``,
                card against CPU.

The phases run in the order above, except that ``rbd_dual``, ``rbd_five``,
``shapes``, ``al_rbd`` and ``al_6dof``, which launch instantiations of
``shapes``, run last (after ``build_instances``), and ``strict``,
``rbd_ls``, ``mpc_batch_rbd`` and ``ddp`` run before ``sharded``.

``--large-times [ROOT]`` prints only the device times of the
``riccati_large.cu`` instantiations of LARGE_TIMES (both entries, both
types) of the port in ROOT (an older tree unpacked beside this one, as for
``--hashes``) or of this tree: run both in one call to compare two plans.

``--xl-times [ROOT]`` does the same for the ``riccati_xl.cu`` rows of
XL_TIMES (the shapes of ``shapes`` that route there and ``rbd_dual``'s
launch), with each entry's stage clocks, copy path and output hash.
``--cluster-times [ROOT]`` does the same for the ``riccati_cluster.cu`` rows
of CLUSTER_TIMES (the shapes of ``shapes`` that route there, in both types,
and ``rbd_five``'s launch), with the blocks a lane and the clusters
resident, and the stage clocks where the tree has a stage-clock build of
that source.  Both are ``source_times``.

Then one line with every kernel's numbers (the batch-first entry in rows of
its own, at each instantiation its path launched; the instantiations of
``shapes`` that no path launched as rows with ``"check_only": true`` and
``launches`` 0), and the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time

import torch

# Published peaks of one H100 SXM (NVIDIA's data sheet): device memory rate,
# float32 rate outside the tensor cores, and float64 on its tensor cores
# (67 TFLOP/s at full precision; riccati_wide.cu uses them).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 67e12}

N, M = 4, 2
HEADLINE = dict(B=4096, T=100)
NOMINAL = [0.3, 0.7, 0.2, 0.5]
KERNEL_SOURCE = "ilqr_tpu_torch/ops/csrc/riccati.cu"
KERNEL_REPLACES = "ilqr_tpu/ops/pallas_riccati.py:437"

# Float32 bound of kernel against plain version, relative to the largest
# magnitude of each output: both run the same formulas with rsqrt, but nvcc
# contracts the kernel's multiply-adds into FMAs and sums in another order,
# and the recursion carries the rounding through T=100 steps.  Measured on
# an H100: 2e-6, of the size of either version's distance from a float64
# run of the same inputs (1.5e-6); the bound leaves a factor of 25.
F32_REL_BOUND = 5e-5
# Float32 bound on `us` between the kernel and the scan backend over a whole
# solve, for lanes that ran the same number of iterations (the backends also
# differ in sqrt-then-divide against rsqrt), relative to max|us|.  Measured
# on an H100: 2.4e-6 with every lane at the same count; the bound leaves
# room for a line-search decision that rounding tips the other way.
F32_SOLVE_REL_BOUND = 1e-3
SOLVE_BUDGET_S = 150.0
# Lane counts the chunked 2-link solve may compact to (of B=4096).
COMPACT_SIZES = (3072, 2048, 512, 128)


# (phase, host clock) of every line printed: the seconds of each phase.
EMITTED = []


def emit(**kw):
    EMITTED.append((kw.get("phase"), time.perf_counter()))
    print(json.dumps(kw), flush=True)


def sync_time(fn, reps):
    """Median milliseconds of ``fn()`` by CUDA events around one call at a
    time, after one warm call: where the host takes longer to issue the call
    than the card to run it, the host's time (the kernels' ``call_ms``; their
    ``ms`` is ``device_time``)."""

    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


# The device's time for a kernel is taken behind a sleep: the calls are
# queued while the card sleeps, so the host's time to issue them (the
# wrapper's checks, allocations and the ctypes call, tens to hundreds of
# microseconds) is not counted.  50 M cycles are at least 25 ms at the
# card's clock of at most 1980 MHz.
SLEEP_CYCLES = 50_000_000
SLEEP_MIN_S = SLEEP_CYCLES / 1.98e9


def device_time(fn, reps):
    """Milliseconds of device time a call of ``fn``: CUDA events around
    ``reps`` calls queued behind a sleep, after one warm call.  Raises if
    issuing them took the host longer than the sleep lasts."""

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    t0 = time.perf_counter()
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    assert host_s < SLEEP_MIN_S, (
        f"issuing {reps} calls took {host_s} s, more than the sleep")
    return a.elapsed_time(b) / reps


def scenario_inputs(B, T, dtype, seed, device):
    """``x0s [B, n]`` around the swing-up's nominal start and zero controls,
    the benchmark's scenario distribution."""

    gen = torch.Generator(device="cpu").manual_seed(seed)
    x0s = (torch.tensor(NOMINAL, dtype=torch.float64)
           + 0.1 * torch.randn((B, N), generator=gen, dtype=torch.float64))
    return x0s.to(dtype).to(device), torch.zeros((B, T, M), dtype=dtype,
                                                 device=device)


def local_models(problem, B, T, dtype, seed, device):
    """Local models at an iterate rolled out under small random controls."""

    from ilqr_tpu_torch.batched import derivatives_bl, rollout_bl

    gen = torch.Generator(device="cpu").manual_seed(seed)
    x0s, _ = scenario_inputs(B, T, dtype, seed + 1, device)
    us = (0.5 * torch.randn((T, M, B), generator=gen, dtype=torch.float64)
          ).to(dtype).to(device)
    xs = rollout_bl(problem, x0s.T.contiguous(), us)
    return derivatives_bl(problem, xs, us)


def riccati_bound_ms(T, B, dtype, N=N, M=M):
    """Least time for one launch: each input read once, each output written
    once, over the memory rate; the recursion's flops over the peak rate."""

    size = torch.empty((), dtype=dtype).element_size()
    per_step_in = N * N + N * M + N + M + N * N + M * N + M * M
    per_step_out = M + M * N
    values = B * (T * (per_step_in + per_step_out) + N + N * N + 1 + 2)
    bytes_ms = values * size / HBM_BYTES_PER_S * 1e3
    # Multiply-adds per lane and step, two flops each: B'S, B's, BtS A,
    # BtS B, Cholesky (M^3/6) and the solves of 1+N right-hand sides, H duff
    # and the two sums, the s update, SA, HK, the S update (A'SA, K'W with
    # W = HK + G, G'K).
    fma = (M * N * N + M * N + M * N * N + M * M * N
           + M * M * M // 6 + (1 + N) * M * M
           + M * M + 2 * M + N * (N + 3 * M)
           + N * N * N + M * M * N + N * N * (N + 2 * M))
    flops_ms = 2 * fma * T * B / PEAK_FLOPS[dtype] * 1e3
    return ((bytes_ms, "bytes") if bytes_ms >= flops_ms
            else (flops_ms, "operations"))


def rel_err(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def last_copy_path():
    """The copy path the last kernel launch took, as its library reported
    it."""

    from ilqr_tpu_torch.ops import cuda_riccati

    return cuda_riccati.last_launch["copy_path"]


def check_kernel(models, reg, symmetrize):
    """Kernel against plain version on the same inputs on the card.

    float64: ``duffs``/``Ks`` to rtol 1e-10, atol 1e-12 and ``dv1``/``dv2`` to
    rtol 1e-9, the bar of the JAX package's own kernel test.  float32: each
    output within F32_REL_BOUND of the plain version, relative to the
    output's largest magnitude.  Returns ``(max abs error, largest relative
    error)`` over the four outputs."""

    from ilqr_tpu_torch.ops.cuda_riccati import (riccati_scan_cuda_bl,
                                                 riccati_scan_plain_bl)

    got = riccati_scan_cuda_bl(*models, reg, symmetrize=symmetrize)
    torch.cuda.synchronize()
    want = riccati_scan_plain_bl(*models, reg, symmetrize=symmetrize)
    return hold(got, want, F32_REL_BOUND)


def hold(got, want, f32_bound):
    """The bars of :func:`check_kernel`, ``got`` against ``want``: float64
    ``duffs``/``Ks`` to rtol 1e-10, atol 1e-12 and ``dv1``/``dv2`` to rtol
    1e-9; float32 each output within ``f32_bound`` of ``want`` relative to
    its largest magnitude.  Returns ``(max abs error, largest relative
    error)``."""

    worst_abs, worst_rel = 0.0, 0.0
    for name, g, w in zip(("duffs", "Ks", "dv1", "dv2"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert bool(torch.isfinite(g).all()), f"{name}: not finite"
        r = rel_err(g, w)
        if g.dtype == torch.float64:
            rtol, atol = (1e-10, 1e-12) if g.ndim > 1 else (1e-9, 0.0)
            torch.testing.assert_close(g, w, rtol=rtol, atol=atol,
                                       msg=lambda m: f"{name}: {m}")
        else:
            assert r <= f32_bound, (name, r, f32_bound)
        worst_abs = max(worst_abs, float((g - w).abs().max()))
        worst_rel = max(worst_rel, r)
    return worst_abs, worst_rel


def phase_kernels(problem, device):
    from ilqr_tpu_torch.ops.cuda_riccati import (kernel_name,
                                                 riccati_scan_cuda_bl,
                                                 riccati_scan_plain_bl,
                                                 riccati_stage_clocks)

    # float64, small, at the bar of the JAX package's own kernel test.
    m64 = local_models(problem, 256, 24, torch.float64, 10, device)
    reg_lane = torch.logspace(-4, 0, 256, dtype=torch.float64, device=device)
    f64_small = max(check_kernel(m64, reg, sym)[0]
                    for reg in (1e-2, reg_lane) for sym in (True, False))

    # float32 at the ragged width, all four flag combinations.
    mrag = local_models(problem, 4099, HEADLINE["T"], torch.float32, 20, device)
    reg_rag = torch.logspace(-4, 0, 4099, dtype=torch.float32, device=device)
    ragged = [check_kernel(mrag, reg, sym)
              for reg in (1e-2, reg_rag) for sym in (True, False)]
    del mrag

    # The main path's shapes, both instantiations: error, time, bound.
    rows = {}
    for dtype in (torch.float32, torch.float64):
        B, T = HEADLINE["B"], HEADLINE["T"]
        models = local_models(problem, B, T, dtype, 30, device)
        reg = torch.full((B,), 1e-2, dtype=dtype, device=device)
        max_abs, max_rel = check_kernel(models, reg, True)
        vs_truth = {}
        if dtype == torch.float32:
            # Where the rounding stands against the truth: the same inputs
            # in float64 through the plain version.
            truth = riccati_scan_plain_bl(*(x.double() for x in models),
                                          reg.double(), symmetrize=True)
            kern = riccati_scan_cuda_bl(*models, reg, symmetrize=True)
            plain = riccati_scan_plain_bl(*models, reg, symmetrize=True)
            vs_truth = {
                "kernel_vs_f64": max(rel_err(k.double(), t)
                                     for k, t in zip(kern, truth)),
                "plain_vs_f64": max(rel_err(p.double(), t)
                                    for p, t in zip(plain, truth))}
        ms = device_time(lambda: riccati_scan_cuda_bl(*models, reg), 30)
        call_ms = sync_time(lambda: riccati_scan_cuda_bl(*models, reg), 30)
        path = last_copy_path()
        plain_ms = sync_time(lambda: riccati_scan_plain_bl(*models, reg), 3)
        bound_ms, bound_by = riccati_bound_ms(T, B, dtype)
        if dtype == torch.float32:
            vs_truth["stage_cycles_per_step"] = riccati_stage_clocks(
                models, reg)
        rows[kernel_name(N, M, dtype)] = dict(
            max_abs_err=max_abs, max_rel_err=max_rel, ms=ms, call_ms=call_ms,
            copy_path=path,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None, **vs_truth)
    emit(phase="kernels", kernels=sorted(rows),
         f64_B256_T24_max_abs_err=f64_small, f64_rtol=1e-10,
         f32_rel_bound=F32_REL_BOUND,
         f32_ragged_B4099_max_abs_rel=[list(r) for r in ragged],
         at_main_path_shapes=rows)
    return rows


def phase_parity(problem, config, device):
    """Small float64 solve: card (kernel) against CPU (plain version)."""

    from ilqr_tpu_torch.parallel.batching import batch_solve

    x0s, us0 = scenario_inputs(8, 24, torch.float64, 40, "cpu")
    cfg = config.replace(max_iter=20)
    cpu = batch_solve(problem, x0s, us0, config=cfg, device="cpu")
    gpu = batch_solve(problem, x0s, us0, config=cfg, device=device)
    assert torch.equal(cpu.status, gpu.status.cpu())
    assert torch.equal(cpu.iterations, gpu.iterations.cpu())
    torch.testing.assert_close(gpu.us.cpu(), cpu.us, rtol=1e-8, atol=1e-10)
    emit(phase="parity", B=8, T=24, dtype="float64",
         status=cpu.status.tolist(), iterations=cpu.iterations.tolist(),
         us_max_abs_diff=float((gpu.us.cpu() - cpu.us).abs().max()))


def time_one_pass(problem, config, x0s, us0, xs=None):
    """Seconds of the first pass, phase by phase, at full width; ``xs``,
    when given, is the rollout of ``x0s`` under ``us0`` (batch-last)."""

    from ilqr_tpu_torch import batched
    from ilqr_tpu_torch.step import initial_state

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    B = x0s.shape[0]
    us = us0.movedim(0, -1).contiguous()
    if xs is None:
        xs = batched.rollout_bl(problem, x0s.T.contiguous(), us)
    state = initial_state(xs, us, config, lane_shape=(B,))
    models, t_d = timed(lambda: batched.derivatives_bl(
        problem, xs, us, chunk=config.derivative_chunk))
    (duffs, Ks, dv1, dv2), t_r = timed(
        lambda: batched.riccati_bl(*models, reg=state.reg, config=config))
    _, t_f = timed(lambda: batched.forward_pass_bl(
        problem, xs, us, duffs, Ks, state.prev_cost, None, config,
        dV1=dv1, dV2=dv2))
    return dict(derivatives_s=t_d, riccati_s=t_r, forward_s=t_f)


def batch_last_phases():
    """The fused engine's phases: ``{label: [(module, function name)]}``."""

    from ilqr_tpu_torch import batched

    return {k: [(batched, k)]
            for k in ("derivatives_bl", "riccati_bl", "forward_pass_bl")}


def per_scenario_phases():
    """The per-scenario engine's phases, as the batched ``solve`` runs them:
    the derivative sweeps of ``backward_pass``, the kernel's batch-first
    entry (its batch-last copy of the inputs included) and ``forward_pass``."""

    from ilqr_tpu_torch import backward, forward
    from ilqr_tpu_torch.ops import riccati_dispatch

    return {"derivatives": [(backward, "problem_linearize"),
                            (backward, "problem_quadratize_running"),
                            (backward, "problem_quadratize_final")],
            "riccati_batch_first": [(riccati_dispatch,
                                     "riccati_scan_cuda_batched")],
            "forward_pass": [(forward, "forward_pass")]}


@contextlib.contextmanager
def phase_clock(phases=None):
    """Seconds spent in each phase's functions while the block runs (a
    synchronize around every call); ``phases`` as :func:`batch_last_phases`
    gives them, which is the default."""

    phases = batch_last_phases() if phases is None else phases
    spent = dict.fromkeys(phases, 0.0)
    originals = [(label, mod, attr, getattr(mod, attr))
                 for label, targets in phases.items()
                 for mod, attr in targets]

    def wrap(label, fn):
        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            spent[label] += time.perf_counter() - t0
            return out

        return timed

    try:
        for label, mod, attr, fn in originals:
            setattr(mod, attr, wrap(label, fn))
        yield spent
    finally:
        for _, mod, attr, fn in originals:
            setattr(mod, attr, fn)


def phase_solve(problem, config, device):
    from ilqr_tpu_torch.batched import make_chunked_batch_solver, rollout_bl
    from ilqr_tpu_torch.config import Status
    from ilqr_tpu_torch.ops import cuda_riccati
    from ilqr_tpu_torch.parallel.batching import (batch_metrics,
                                                  make_batch_solver)

    B, T = HEADLINE["B"], HEADLINE["T"]
    x0s, us0 = scenario_inputs(B, T, torch.float32, 0, device)

    # Time one pass first; cap max_iter (never B, T, n or m) if the full
    # number of passes, run four times below, would not fit the budget.
    first = time_one_pass(problem, config, x0s, us0)
    pass_s = sum(first.values())
    cap = max(3, min(config.max_iter, int(SOLVE_BUDGET_S / (4 * 2 * pass_s))))
    cfg = config.replace(max_iter=cap)

    def run(cfg_run, x0s_run, us0_run):
        solve_fn = make_batch_solver(problem, cfg_run, engine="fused",
                                     device=device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve_fn(x0s_run, us0_run)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    def check(res, dtype, cfg_run):
        assert res.us.shape == (B, T, M) and res.xs.shape == (B, T + 1, N)
        assert res.us.dtype == dtype and res.status.dtype == torch.int32
        ok = ((res.status == int(Status.CONVERGED))
              | (res.status == int(Status.MAX_ITER)))
        assert bool(ok.all()), res.status.unique().tolist()
        for f in (res.xs, res.us, res.cost):
            assert bool(torch.isfinite(f).all())
        return int(res.iterations.max())

    # The main path, float32: counts set to 0 just before, read just after.
    cuda_riccati.reset_launch_counts()
    res, solve_s = run(cfg, x0s, us0)
    counts = dict(cuda_riccati.launch_counts)
    passes = check(res, torch.float32, cfg)
    assert counts["riccati_cuda_4x2_f32"] == passes >= 1, (counts, passes)
    assert counts["riccati_cuda_4x2_f64"] == 0, counts

    # The same path in float64, a few passes: the other instantiation.
    cfg64 = cfg.replace(max_iter=min(cap, 3))
    cuda_riccati.reset_launch_counts()
    res64, solve64_s = run(cfg64, x0s.double(), us0.double())
    counts64 = dict(cuda_riccati.launch_counts)
    passes64 = check(res64, torch.float64, cfg64)
    assert counts64["riccati_cuda_4x2_f64"] == passes64 >= 1, (counts64, passes64)
    assert counts64["riccati_cuda_4x2_f32"] == 0, counts64

    # The scan backend on the same float32 inputs.
    cuda_riccati.reset_launch_counts()
    ref, scan_s = run(cfg.replace(backward_backend="scan"), x0s, us0)
    assert cuda_riccati.launches() == 0
    check(ref, torch.float32, cfg)
    same_it = res.iterations == ref.iterations
    same_status = res.status == ref.status
    frac_same = float(same_it.float().mean())
    assert frac_same >= 0.98, frac_same
    assert bool(same_status[same_it].all())
    us_rel = float((res.us[same_it] - ref.us[same_it]).abs().max()
                   / ref.us.abs().max())
    assert us_rel <= F32_SOLVE_REL_BOUND, us_rel

    # Once more with each phase timed (a synchronize around every call).
    with phase_clock() as spent:
        res2, timed_s = run(cfg, x0s, us0)
    assert torch.equal(res2.status, res.status)

    # The same solve through the chunked solver, with straggler compaction
    # on the card: lanes finish at different passes, so after a chunk the
    # running ones fit a listed size and are gathered into a smaller batch.
    chunks = []
    chunked_fn = make_chunked_batch_solver(
        problem, cfg, iter_chunk=2, compact_sizes=COMPACT_SIZES,
        device=device, on_chunk=lambda p, r: chunks.append((p, r)))
    xs0 = rollout_bl(problem, x0s.T.contiguous(),
                     us0.movedim(0, -1).contiguous()).movedim(-1, 0)
    res_c = chunked_fn(xs0.contiguous(), us0)
    torch.cuda.synchronize()
    compactions = [r for _, r in chunks[:-1] if 0 < r <= COMPACT_SIZES[0]]
    assert compactions, chunks
    # The step is per-lane, so compaction changes no lane's arithmetic but
    # the order of the sums over time, which PyTorch picks from the batch
    # width: held like the scan backend, bit-equality reported.
    same_c = res_c.iterations == res.iterations
    frac_same_c = float(same_c.float().mean())
    assert frac_same_c >= 0.98, frac_same_c
    assert torch.equal(res_c.status[same_c], res.status[same_c])
    us_rel_c = float((res_c.us[same_c] - res.us[same_c]).abs().max()
                     / res.us.abs().max())
    assert us_rel_c <= F32_SOLVE_REL_BOUND, us_rel_c

    metrics = {k: float(v) for k, v in batch_metrics(res).items()}
    emit(phase="solve", B=B, T=T, n=N, m=M, dtype="float32",
         max_iter_cap=cap, max_iter_config=config.max_iter,
         first_pass_s=first, passes=passes, launches=counts,
         solve_s=solve_s, solves_per_s=B / solve_s,
         lanes_converged=int(metrics["n_converged"]),
         mean_iterations=metrics["mean_iterations"],
         mean_cost=metrics["mean_cost"],
         per_pass_s={k: v / passes for k, v in spent.items()},
         per_pass_other_s=(timed_s - sum(spent.values())) / passes,
         timed_solve_s=timed_s,
         f64={"passes": passes64, "launches": counts64, "solve_s": solve64_s},
         scan={"solve_s": scan_s, "lanes_same_iterations": frac_same,
               "us_rel_diff_same_lanes": us_rel,
               "bound": F32_SOLVE_REL_BOUND},
         chunked={"iter_chunk": 2, "compact_sizes": list(COMPACT_SIZES),
                  "chunks": chunks, "compaction_fired": True,
                  "running_lanes_when_compacted": compactions,
                  "lanes_same_iterations": frac_same_c,
                  "us_rel_diff_same_lanes": us_rel_c,
                  "bound": F32_SOLVE_REL_BOUND,
                  "bit_equal_to_fused_solve": all(
                      torch.equal(getattr(res_c, f), getattr(res, f))
                      for f in ("status", "iterations", "us", "cost"))})
    return ({"riccati_cuda_4x2_f32": counts["riccati_cuda_4x2_f32"],
             "riccati_cuda_4x2_f64": counts64["riccati_cuda_4x2_f64"]},
            res, cfg)


# ---------------------------------------------------------------------------
# The second main path: the floating-base arms of the rigid-body layer.
# ---------------------------------------------------------------------------

WIDE_SOURCE = "ilqr_tpu_torch/ops/csrc/riccati_wide.cu"
LARGE_SOURCE = "ilqr_tpu_torch/ops/csrc/riccati_large.cu"
XL_SOURCE = "ilqr_tpu_torch/ops/csrc/riccati_xl.cu"
CLUSTER_SOURCE = "ilqr_tpu_torch/ops/csrc/riccati_cluster.cu"
# cuda_riccati.route's source -> its file.
SOURCE_FILES = {"riccati": KERNEL_SOURCE, "riccati_wide": WIDE_SOURCE,
                "riccati_large": LARGE_SOURCE, "riccati_xl": XL_SOURCE,
                "riccati_cluster": CLUSTER_SOURCE}
# The sources built only as instantiations at first use, one lane a block:
# their builds report the blocks resident on an SM, and their float32 rows
# of phase shapes the cycles a step by stage.
ONE_LANE_A_BLOCK = ("riccati_large", "riccati_xl")
# snapshot_every: bench.py --config rbd's default (bench.py:388).
# max_iter_cut: the passes of the cut solve, 1, cut from 15 (to 10 with
# the kernel at any shape and the multi-device entry points, to 5 with
# al_6dof and the examples, to 3 when a host whose cores are shared ran the
# script in 969 s, to 2 when rbd_dual and the riccati_xl.cu rows of shapes
# took it to 1015 s on an H100, to 1 with rbd_ls, which runs this solve's
# path for two passes) so that the script fits its time (the width is
# unchanged).
RBD = dict(B=256, T=1000, T_cut=100, max_iter_cut=1, max_iter=100,
           snapshot_every=4)
SIX = dict(B=64, T=50, max_iter=15, min_iter=1)
# Seconds the RBD solve and its scan twin may take together: decides T, and
# stops the solve at a chunk boundary once half of it is spent.
RBD_BUDGET_S = 150.0
# Rungs of the line-search ladder the timed forward pass at T=1000 may climb
# (a rung is one rollout of the whole batch, half a minute there).
FULL_DEPTH_RUNGS = 3
# The same for the 6-DoF solve, its float64 run and its scan twin: caps
# max_iter from the time of the first pass (cut from 100 s with al_6dof, to
# 40 s with RBD["max_iter_cut"], to 20 s, one pass on an H100, with
# rbd_five, for the same reason); at least min_iter passes, and min_iter in
# float64 (3 until rbd_dual came, for the same reason).  The first pass is
# held tightly against the scan backend on its own (compare_first_pass),
# whatever the cut.
SIX_BUDGET_S = 20.0
# The free-flying dual arm (n=36, m=18: the kernel in riccati_xl.cu),
# scripts/bench_6dof.py's B and T; its solve and scan twin may take
# DUAL_BUDGET_S together, which caps max_iter from the time of the first
# pass (at least DUAL["min_iter"]).
DUAL = dict(B=64, T=50, max_iter=15, min_iter=1)
DUAL_BUDGET_S = 40.0

# Float32 bound of the lane-spread kernel against the plain version,
# relative to each output's largest magnitude.  The reasons are those of
# F32_REL_BOUND (FMA contraction, another order of the sums, and here K'(HK
# + G) where the plain version adds K'HK and K'G), but the recursion carries
# the rounding through T=1000 steps of 16x16 products instead of T=100 of
# 4x4.  Measured on an H100: 6.5e-6 at (16, 8), B=256, T=1000 and 4.1e-6 at
# (24, 12), B=64, T=50; the bound leaves a factor of 15.  Both versions are
# also held against a float64 run of the same
# inputs: the kernel may be at most KERNEL_VS_PLAIN_SLACK times as far from
# it as the plain version, so the bound cannot hide a kernel that is worse.
F32_REL_BOUND_RBD = 1e-4
# The same in float64 at those depths, where entries that are rounding noise
# beside the largest no longer meet an elementwise rtol (the small sizes are
# held to the elementwise rtol 1e-10 / atol 1e-12 of the JAX package's kernel
# test).  Measured: 9.5e-15.
F64_REL_BOUND_RBD = 1e-9
KERNEL_VS_PLAIN_SLACK = 3.0
# Float32 `us` of an RBD solve, kernel backend against scan backend, lanes
# with the same iteration count, relative to max|us|.
# After ONE pass from the same state the two differ by the rounding of one
# recursion (reciprocals, order of the sums) carried through one closed-loop
# rollout: the worst lane is held to F32_FIRST_PASS_REL_BOUND_RBD, and every
# lane must have accepted the same alpha.
# After a solve cut mid-descent (5 to 15 passes of a problem that needs
# more) each pass has amplified the last one's difference, and the worst
# lane ends the cut on a visibly different iterate.  Measured on an H100, all
# lanes on the same count: 2-DoF arm, B=256, T=100, 10 passes: worst lane
# 0.079, median lane 9.1e-5, worst cost 2.9e-2; 6-DoF arm, B=64, T=50: worst
# lane 9.4e-7 after 5 passes, 1.4e-3 in a run whose cap was higher (its
# count was not printed), 1.6e-6 after 9 (converged).  There the worst lane is reported, and the MEDIAN lane
# and the worst lane's relative cost difference are held.
F32_FIRST_PASS_REL_BOUND_RBD = 1e-4
F32_SOLVE_MEDIAN_BOUND_RBD = 2e-3
F32_SOLVE_COST_BOUND_RBD = 5e-2
# Float64 `us`, card (kernel, cuBLAS products) against CPU (plain version)
# after a few passes, relative to max|us|.  Measured: 1.3e-15.
F64_PARITY_REL_BOUND_RBD = 1e-9


def rbd_case(six_dof):
    """``(problem, nominal state, per-component noise)`` of the reference's
    2-DoF arm (``bench.py --config rbd``: pose-only noise 0.05, attitude
    0.4 of it), the 6-DoF arm (``scripts/bench_6dof.py``: 0.02 on every
    component) or, ``six_dof="dual"`` or ``"five"``, the free-flying dual
    arm or five-arm (two or five 6-DoF arms on one base: the 6-DoF case
    extended to 36 or 72 components)."""

    from ilqr_tpu_torch.models.rbd import (DUAL_6DOF_ARM_URDF,
                                           FIVE_6DOF_ARM_URDF,
                                           SIX_DOF_ARM_URDF,
                                           make_rbd_arm_problem)

    if six_dof in ("dual", "five"):
        arms = 2 if six_dof == "dual" else 5
        problem = make_rbd_arm_problem(
            target_pose=[0.0, 0.0, 0.0, 1.0, 1.0, 1.0] + [0.3] * (6 * arms),
            urdf_path=(DUAL_6DOF_ARM_URDF if arms == 2
                       else FIVE_6DOF_ARM_URDF))
        n = 12 + 12 * arms
        return problem, [0.0, 0.0, 1.0] + [0.0] * (n - 3), [0.02] * n
    if six_dof:
        problem = make_rbd_arm_problem(
            target_pose=[0.0, 0.0, 0.0, 1.0, 1.0, 1.0] + [0.3] * 6,
            urdf_path=SIX_DOF_ARM_URDF)
        return problem, [0.0, 0.0, 1.0] + [0.0] * 21, [0.02] * 24
    problem = make_rbd_arm_problem()
    noise = 0.05
    return (problem, [0.0, 0.0, 1.0, 0.5, 0.75, 1.0, 0.0, 0.0] + [0.0] * 8,
            [0.4 * noise] * 3 + [noise] * 5 + [0.0] * 8)


def rbd_inputs(case, B, T, dtype, seed, device):
    problem, nominal, scale = case
    gen = torch.Generator(device="cpu").manual_seed(seed)
    x0s = (torch.tensor(nominal, dtype=torch.float64)
           + torch.tensor(scale, dtype=torch.float64)
           * torch.randn((B, problem.state_dim), generator=gen,
                         dtype=torch.float64))
    return x0s.to(dtype).to(device), torch.zeros(
        (B, T, problem.control_dim), dtype=dtype, device=device)


def rbd_local_models(case, B, T, dtype, seed, device, timings=None,
                     chunk=None):
    """Local models of the RBD problem at an iterate rolled out under small
    random controls: the conditioning of ``H + reg I`` a solve sees.  With
    ``timings`` (a dict) the seconds of the rollout — one rung of the
    line-search ladder — and of ``derivatives_bl`` are written into it.
    ``chunk``: ``derivatives_bl``'s, by default ``bench.py``'s (100 at
    T >= 500, else 0).  Returns ``(models, xs, us)``."""

    from ilqr_tpu_torch.batched import derivatives_bl, rollout_bl

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    problem = case[0]
    x0s, _ = rbd_inputs(case, B, T, dtype, seed, device)
    gen = torch.Generator(device="cpu").manual_seed(seed + 1)
    us = (0.1 * torch.randn((T, problem.control_dim, B), generator=gen,
                            dtype=torch.float64)).to(dtype).to(device)
    xs, rollout_s = timed(lambda: rollout_bl(problem, x0s.T.contiguous(), us))
    if chunk is None:
        chunk = 100 if T >= 500 else 0
    models, derivatives_s = timed(lambda: derivatives_bl(
        problem, xs, us, chunk=chunk))
    if timings is not None:
        timings.update(rollout_rung_s=rollout_s, derivatives_s=derivatives_s)
    return models, xs, us


def rbd_config(max_iter, T, backend="pallas"):
    """``bench.py --config rbd``'s solver flags (Tassa regularization)."""

    from ilqr_tpu_torch.config import ILQRConfig

    return ILQRConfig(max_iter=max_iter, tol=1e-5, tol_grad=1e-10,
                      tol_grad_rel=1e-6, adaptive_reg=True, reg=1.0,
                      reg_min=1e-3, reg_scale=10.0, reg_backtrack_trigger=1,
                      backward_backend=backend,
                      derivative_chunk=100 if T >= 500 else 0)


def time_forward_pass(problem, xs, us, gains, config):
    """Seconds of one ``forward_pass_bl`` from the iterate ``(xs, us)`` with
    the kernel's gains, the ladder capped at FULL_DEPTH_RUNGS rungs; the rungs
    it climbed and the lanes that accepted a step within them."""

    from ilqr_tpu_torch import batched

    duffs, Ks, dv1, dv2 = gains
    cost = batched.total_cost_bl(problem, xs, us)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = batched.forward_pass_bl(
        problem, xs, us, duffs, Ks, cost, None,
        config.replace(max_backtracks=FULL_DEPTH_RUNGS), dV1=dv1, dV2=dv2)
    torch.cuda.synchronize()
    accepted, bts = out[3], out[5]
    return dict(forward_pass_s=time.perf_counter() - t0,
                forward_pass_rungs=min(int(bts.max()) + 1, FULL_DEPTH_RUNGS),
                forward_pass_rung_cap=FULL_DEPTH_RUNGS,
                forward_pass_lanes_accepted=int(accepted.sum()))


def phase_rbd_kernels(cases, device):
    from ilqr_tpu_torch.ops.cuda_riccati import (kernel_name,
                                                 riccati_scan_cuda_bl,
                                                 riccati_scan_plain_bl,
                                                 riccati_stage_clocks)

    rows, small, one_pass, paths, stage = {}, {}, {}, {}, {}
    for tag, case, full in (("16x8", cases[False], RBD),
                            ("24x12", cases[True], SIX)):
        n, m = case[0].state_dim, case[0].control_dim

        # float64, small, the four flag combinations; then the ragged sizes,
        # which take the per-element copy path (B * 8 bytes is no multiple
        # of 16), and B=65 in float32 (B * 4 bytes neither).
        errs = []
        for B, dtype in ((64, torch.float64), (257, torch.float64),
                         (67, torch.float64), (65, torch.float32)):
            models = rbd_local_models(case, B, 24, torch.float64, 50 + B,
                                      device)[0]
            models = tuple(x.to(dtype) for x in models)
            reg_lane = torch.logspace(-3, 0, B, dtype=dtype, device=device)
            combos = ([(r, s) for r in (1.0, reg_lane) for s in (True, False)]
                      if B == 64 else [(reg_lane, True)])
            if dtype == torch.float32:
                combos = [(1.0, True)]   # the main path's reg, float32
            errs.append(max(check_kernel(models, r, s)[0]
                            for r, s in combos))
            paths[f"{tag}_B{B}_{str(dtype)[6:]}"] = last_copy_path()
        small[tag] = dict(zip(("B64_T24", "B257_T24", "B67_T24",
                               "B65_T24_float32"), errs))

        # The main path's shapes: error, time, bound, both instantiations.
        # The plain version takes seconds here (thousands of launches a
        # step), so it runs once per type and that call is the one timed.
        B, T = full["B"], full["T"]
        one_pass[tag] = dict(B=B, T=T)
        if T > RBD["T_cut"]:
            # At T=1000 the local models of a T_cut-step iterate, tiled:
            # the same recursion over the arm's local models at the main
            # path's depth, without a T=1000 rollout (26 s on an H100).
            # Their derivative sweep runs in chunks, as bench.py's at T=1000
            # (--deriv-chunk 100), here of half the horizon.
            m32, xs, us = rbd_local_models(case, B, RBD["T_cut"],
                                           torch.float32, 60, device,
                                           chunk=RBD["T_cut"] // 2)
            reps = T // RBD["T_cut"]
            m32 = tuple(x.repeat((reps,) + (1,) * (x.ndim - 1))
                        for x in m32[:7]) + m32[7:]
            one_pass[tag]["tiled_from_T"] = RBD["T_cut"]
        else:
            m32, xs, us = rbd_local_models(case, B, T, torch.float32, 60,
                                           device, timings=one_pass[tag])
        m64 = tuple(x.double() for x in m32)
        plain, plain_ms = {}, {}
        for dtype, models in ((torch.float32, m32), (torch.float64, m64)):
            reg = torch.full((B,), 1.0, dtype=dtype, device=device)
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            plain[dtype] = riccati_scan_plain_bl(*models, reg, symmetrize=True)
            b.record()
            torch.cuda.synchronize()
            plain_ms[dtype] = a.elapsed_time(b)
        truth = plain[torch.float64]
        for dtype, models in ((torch.float32, m32), (torch.float64, m64)):
            reg = torch.full((B,), 1.0, dtype=dtype, device=device)
            kern = riccati_scan_cuda_bl(*models, reg, symmetrize=True)
            torch.cuda.synchronize()
            bound = (F32_REL_BOUND_RBD if dtype == torch.float32
                     else F64_REL_BOUND_RBD)
            max_abs, max_rel = 0.0, 0.0
            for name, k, p in zip(("duffs", "Ks", "dv1", "dv2"), kern,
                                  plain[dtype]):
                assert bool(torch.isfinite(k).all()), f"{name}: not finite"
                r = rel_err(k, p)
                assert r <= bound, (tag, str(dtype), name, r, bound)
                max_abs = max(max_abs, float((k - p).abs().max()))
                max_rel = max(max_rel, r)
            vs_truth = {}
            if dtype == torch.float32:
                k64 = max(rel_err(k.double(), t) for k, t in zip(kern, truth))
                p64 = max(rel_err(p.double(), t)
                          for p, t in zip(plain[dtype], truth))
                assert k64 <= max(KERNEL_VS_PLAIN_SLACK * p64, 1e-6), (k64,
                                                                       p64)
                vs_truth = {"kernel_vs_f64": k64, "plain_vs_f64": p64}
            ms = device_time(lambda: riccati_scan_cuda_bl(*models, reg), 30)
            call_ms = sync_time(lambda: riccati_scan_cuda_bl(*models, reg), 30)
            bound_ms, bound_by = riccati_bound_ms(T, B, dtype, n, m)
            paths[f"{tag}_B{B}_{str(dtype)[6:]}"] = last_copy_path()
            extra = {}
            if T > RBD["T_cut"]:
                # The depth the cut RBD solve launches the kernel at.
                cut = tuple(x[:RBD["T_cut"]] for x in models[:7]) + models[7:]
                extra = dict(
                    T_cut=RBD["T_cut"],
                    ms_T_cut=device_time(
                        lambda: riccati_scan_cuda_bl(*cut, reg), 30),
                    bound_ms_T_cut=riccati_bound_ms(RBD["T_cut"], B, dtype,
                                                    n, m)[0])
                del cut
            if dtype == torch.float32 and full is RBD:
                stage[kernel_name(n, m, dtype)] = riccati_stage_clocks(
                    models, reg)
            rows[kernel_name(n, m, dtype)] = dict(
                B=B, T=T, max_abs_err=max_abs, max_rel_err=max_rel, ms=ms,
                call_ms=call_ms, plain_ms=plain_ms[dtype], bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None, **extra, **vs_truth)
            if dtype == torch.float32:
                one_pass[tag]["riccati_s"] = ms / 1e3
                if full is not RBD:
                    continue
                # One whole pass at the cut solve's depth (the ladder of a
                # T=1000 pass took over a minute of the script's budget).
                cut = dict(B=B, T=RBD["T_cut"])
                mc, xc, uc = rbd_local_models(case, B, RBD["T_cut"],
                                              torch.float32, 61, device,
                                              timings=cut)
                kc = riccati_scan_cuda_bl(*mc, reg, symmetrize=True)
                cut["riccati_s"] = device_time(
                    lambda: riccati_scan_cuda_bl(*mc, reg), 30) / 1e3
                cut.update(time_forward_pass(case[0], xc, uc, kc,
                                             rbd_config(1, RBD["T_cut"])))
                one_pass[f"{tag}_T{RBD['T_cut']}"] = cut
                del mc, xc, uc, kc
        del plain, truth, kern
        del m32, m64, xs, us
    emit(phase="rbd_kernels", kernels=sorted(rows), f64_rtol=1e-10,
         f64_rel_bound_at_main_path_shapes=F64_REL_BOUND_RBD,
         f64_max_abs_err=small, f32_rel_bound=F32_REL_BOUND_RBD,
         copy_paths=paths, stage_cycles_per_step=stage,
         kernel_vs_plain_slack=KERNEL_VS_PLAIN_SLACK,
         at_main_path_shapes=rows, one_pass_float32_s=one_pass)
    return rows, one_pass[f"16x8_T{RBD['T_cut']}"]


def check_rbd_result(res, cost0, B, T, n, m, dtype):
    """Shapes, types, a valid final status on every lane, and a finite cost
    no higher than the initial one.  Returns lanes by final status."""

    from ilqr_tpu_torch.config import Status

    assert res.us.shape == (B, T, m) and res.xs.shape == (B, T + 1, n)
    assert res.us.dtype == dtype and res.status.dtype == torch.int32
    final = (int(Status.CONVERGED), int(Status.MAX_ITER),
             int(Status.LINESEARCH_FAILED))
    by_status = {Status(c).name: int((res.status == c).sum()) for c in final}
    assert sum(by_status.values()) == B, res.status.unique().tolist()
    for f in (res.xs, res.us, res.cost):
        assert bool(torch.isfinite(f).all())
    slack = 1e-5 if dtype == torch.float32 else 1e-12
    assert bool((res.cost <= cost0 * (1.0 + slack)).all()), (
        float((res.cost / cost0).max()))
    return by_status


def compare_backends(res, ref, bound):
    """``us`` of two solves on the lanes that ran the same number of
    iterations, relative to max|us|: the worst lane is held to ``bound``
    (reported only where ``bound`` is None), the median lane and the worst
    lane's cost to their own bounds."""

    same_it = res.iterations == ref.iterations
    assert bool(same_it.any())
    per_lane = ((res.us - ref.us).abs().amax(dim=(1, 2))
                / ref.us.abs().max())[same_it]
    cost_rel = ((res.cost - ref.cost).abs() / ref.cost.abs())[same_it]
    out = {"lanes_same_iterations": float(same_it.float().mean()),
           "us_rel_diff_same_lanes": float(per_lane.max()),
           "us_rel_diff_median_lane": float(per_lane.median()),
           "cost_rel_diff_worst_lane": float(cost_rel.max()),
           "cost_rel_diff_median_lane": float(cost_rel.median()),
           "bound": bound, "median_bound": F32_SOLVE_MEDIAN_BOUND_RBD,
           "cost_bound": F32_SOLVE_COST_BOUND_RBD}
    assert bound is None or out["us_rel_diff_same_lanes"] <= bound, out
    assert out["us_rel_diff_median_lane"] <= F32_SOLVE_MEDIAN_BOUND_RBD, out
    assert out["cost_rel_diff_worst_lane"] <= F32_SOLVE_COST_BOUND_RBD, out
    return out


def compare_first_pass(one_k, one_s):
    """One pass from the same state through the kernel and through the scan
    backend: rounding has not been amplified yet, so every lane must have
    accepted the same alpha and the worst lane's ``us`` is held tightly."""

    assert torch.equal(one_k.iterations, one_s.iterations)
    assert torch.equal(one_k.alpha, one_s.alpha), (one_k.alpha, one_s.alpha)
    return compare_backends(one_k, one_s, F32_FIRST_PASS_REL_BOUND_RBD)


def phase_rbd_solve(case, device, one_pass_cut):
    """``one_pass_cut``: seconds of ``derivatives_bl``, the Riccati kernel
    and ``forward_pass_bl`` at T=RBD["T_cut"], from the ``rbd_kernels``
    phase; a pass at the reference's T=1000 is taken as T/T_cut times as
    long (the sweep, the recursion and every rung are linear in T)."""

    from ilqr_tpu_torch import batched
    from ilqr_tpu_torch.ops import cuda_riccati

    problem = case[0]
    n, m, B = problem.state_dim, problem.control_dim, RBD["B"]
    name = cuda_riccati.kernel_name(n, m, torch.float32)

    # A pass is the derivative sweep, the recursion and the forward pass;
    # five of them and their scan twins must fit the budget.
    T, max_iter = RBD["T_cut"], RBD["max_iter_cut"]
    pass_s = (one_pass_cut["derivatives_s"] + one_pass_cut["riccati_s"]
              + one_pass_cut["forward_pass_s"]) * RBD["T"] / RBD["T_cut"]
    if 2 * 5 * pass_s <= RBD_BUDGET_S:
        T = RBD["T"]
        max_iter = min(RBD["max_iter"], int(RBD_BUDGET_S / (2 * pass_s)))
    else:
        print(f"chip_smoke: rbd_solve: T cut from {RBD['T']} to {T} and "
              f"max_iter from {RBD['max_iter']} to {max_iter}: five passes at "
              f"T={RBD['T']} and their scan twins do not fit the "
              f"{RBD_BUDGET_S} s budget", file=sys.stderr, flush=True)
    x0s, us0 = rbd_inputs(case, B, T, torch.float32, 0, device)
    xs_bl = batched.rollout_bl(problem, x0s.T.contiguous(),
                               us0.movedim(0, -1).contiguous())
    cost0 = batched.total_cost_bl(problem, xs_bl,
                                  us0.movedim(0, -1).contiguous())
    xs0 = xs_bl.movedim(-1, 0).contiguous()

    def run(backend, passes_cap, budget_s=None):
        chunks = []
        t0 = time.perf_counter()

        def on_chunk(passes, running):
            chunks.append((passes, running))
            return (budget_s is not None
                    and time.perf_counter() - t0 > budget_s)

        solve_fn = batched.make_chunked_batch_solver(
            problem, rbd_config(passes_cap, T, backend), iter_chunk=10,
            compact_sizes=(128,), device=device, on_chunk=on_chunk,
            snapshot_every=RBD["snapshot_every"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve_fn(xs0, us0)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0, chunks

    # The main path: counts set to 0 just before, read just after.  It stops
    # at a chunk boundary once half the budget is spent.
    cuda_riccati.reset_launch_counts()
    with phase_clock() as spent:
        res, solve_s, chunks = run("pallas", max_iter, RBD_BUDGET_S / 2)
    counts = dict(cuda_riccati.launch_counts)
    passes = chunks[-1][0]
    by_status = check_rbd_result(res, cost0, B, T, n, m, torch.float32)
    assert counts[name] == passes >= 1, (counts, passes)
    assert sum(counts.values()) == passes, counts
    compacted = any(0 < r <= 128 for _, r in chunks[:-1])
    if passes < max_iter and chunks[-1][1] > 0:
        print(f"chip_smoke: rbd_solve: stopped after {passes} of {max_iter} "
              f"passes by the {RBD_BUDGET_S} s budget", file=sys.stderr,
              flush=True)

    emit(phase="rbd_solve", B=B, T=T, n=n, m=m, dtype="float32",
         max_iter=max_iter, snapshot_every=RBD["snapshot_every"],
         one_pass_at_T_cut_s=one_pass_cut,
         passes=passes,
         launches=counts, solve_s=solve_s, chunks=chunks,
         compaction_fired=compacted, lanes_by_status=by_status,
         mean_iterations=float(res.iterations.float().mean()),
         mean_cost_ratio=float((res.cost / cost0).mean()),
         per_pass_s={k: v / passes for k, v in spent.items()},
         per_pass_other_s=(solve_s - sum(spent.values())) / passes)

    # The same passes through the scan backend, and one pass from the same
    # state through each (where the solve is one pass, the two solves).
    cuda_riccati.reset_launch_counts()
    ref, scan_s, _ = run("scan", passes)
    assert cuda_riccati.launches() == 0
    check_rbd_result(ref, cost0, B, T, n, m, torch.float32)
    first_pass = compare_first_pass(*(
        (res, ref) if passes == 1 else
        (run(b, 1)[0] for b in ("pallas", "scan"))))
    emit(phase="rbd_solve_scan", solve_s=scan_s, passes=passes,
         after_first_pass=first_pass, **compare_backends(res, ref, None))
    return {name: counts[name]}


def phase_rbd_parity(case, device):
    """Small float64 RBD solve: card (kernel) against CPU (plain version)."""

    from ilqr_tpu_torch import batched
    from ilqr_tpu_torch.ops import cuda_riccati

    problem = case[0]
    B, T = 8, 24
    x0s, us0 = rbd_inputs(case, B, T, torch.float64, 70, "cpu")
    # 2 passes in chunks of one (cut from 4 in chunks of 2 with rbd_ls,
    # whose float64 check runs this path with its flags).
    cfg = rbd_config(2, T)
    name = cuda_riccati.kernel_name(problem.state_dim, problem.control_dim,
                                    torch.float64)

    def run(dev):
        xs0 = batched.rollout_bl(problem, x0s.T.contiguous().to(dev),
                                 us0.movedim(0, -1).contiguous().to(dev))
        solve_fn = batched.make_chunked_batch_solver(
            problem, cfg, iter_chunk=1, compact_sizes=(4,), device=dev,
            on_chunk=lambda p, r: chunks.append((p, r)))
        return solve_fn(xs0.movedim(-1, 0).contiguous(), us0)

    chunks = []
    cpu = run("cpu")
    chunks.clear()
    cuda_riccati.reset_launch_counts()
    gpu = run(device)
    counts = dict(cuda_riccati.launch_counts)
    passes = int(gpu.iterations.max())
    assert counts[name] == passes >= 1, (counts, passes)
    assert torch.equal(cpu.status, gpu.status.cpu())
    assert torch.equal(cpu.iterations, gpu.iterations.cpu())
    us_rel = float((gpu.us.cpu() - cpu.us).abs().max() / cpu.us.abs().max())
    assert us_rel <= F64_PARITY_REL_BOUND_RBD, us_rel
    emit(phase="rbd_parity", B=B, T=T, dtype="float64", passes=passes,
         launches=counts, status=cpu.status.tolist(), chunks=chunks,
         compaction_fired=any(0 < r <= 4 for _, r in chunks[:-1]),
         iterations=cpu.iterations.tolist(), us_rel_diff=us_rel,
         bound=F64_PARITY_REL_BOUND_RBD)
    return {name: counts[name]}


def phase_rbd_6dof(case, device):
    from ilqr_tpu_torch import batched
    from ilqr_tpu_torch.ops import cuda_riccati
    from ilqr_tpu_torch.parallel.batching import make_batch_solver

    problem = case[0]
    n, m = problem.state_dim, problem.control_dim
    B, T = SIX["B"], SIX["T"]
    x0s, us0 = rbd_inputs(case, B, T, torch.float32, 80, device)
    us_bl = us0.movedim(0, -1).contiguous()
    cost0 = batched.total_cost_bl(
        problem, batched.rollout_bl(problem, x0s.T.contiguous(), us_bl),
        us_bl)

    def run(cfg, x0s_run, us0_run):
        solve_fn = make_batch_solver(problem, cfg, engine="fused",
                                     device=device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve_fn(x0s_run, us0_run)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    name32 = cuda_riccati.kernel_name(n, m, torch.float32)
    name64 = cuda_riccati.kernel_name(n, m, torch.float64)
    # A later pass climbs more rungs than the first: count it 2.5 times, and
    # the float64 run and the scan twin as 1.2 more solves.
    first = time_one_pass(problem, rbd_config(SIX["max_iter"], T), x0s, us0)
    max_iter = max(SIX["min_iter"], min(SIX["max_iter"], int(
        SIX_BUDGET_S / (2.2 * 2.5 * sum(first.values())))))
    cfg = rbd_config(max_iter, T)
    if max_iter < SIX["max_iter"]:
        print(f"chip_smoke: rbd_6dof: max_iter cut from {SIX['max_iter']} to "
              f"{max_iter} by the {SIX_BUDGET_S} s budget", file=sys.stderr,
              flush=True)
    cuda_riccati.reset_launch_counts()
    with phase_clock() as spent:
        res, solve_s = run(cfg, x0s, us0)
    counts = dict(cuda_riccati.launch_counts)
    passes = int(res.iterations.max())
    by_status = check_rbd_result(res, cost0, B, T, n, m, torch.float32)
    assert counts[name32] == passes >= 1, (counts, passes)
    assert sum(counts.values()) == passes, counts

    # The same path in float64, a few passes: the other instantiation.
    cuda_riccati.reset_launch_counts()
    res64, solve64_s = run(cfg.replace(max_iter=SIX["min_iter"]), x0s.double(),
                           us0.double())
    counts64 = dict(cuda_riccati.launch_counts)
    passes64 = int(res64.iterations.max())
    check_rbd_result(res64, cost0.double(), B, T, n, m, torch.float64)
    assert counts64[name64] == passes64 >= 1, (counts64, passes64)

    cuda_riccati.reset_launch_counts()
    ref, scan_s = run(cfg.replace(backward_backend="scan"), x0s, us0)
    assert cuda_riccati.launches() == 0
    scan = compare_backends(res, ref, None)
    # One pass from the same state through both backends: where the cut
    # leaves one pass, the two solves above are those passes.
    first_pass = compare_first_pass(*(
        (res, ref) if max_iter == 1 else
        (run(cfg.replace(max_iter=1, backward_backend=b), x0s, us0)[0]
         for b in ("pallas", "scan"))))

    emit(phase="rbd_6dof", B=B, T=T, n=n, m=m, dtype="float32",
         max_iter=max_iter, max_iter_config=SIX["max_iter"],
         first_pass_s=first, passes=passes, launches=counts,
         solve_s=solve_s, lanes_by_status=by_status,
         mean_iterations=float(res.iterations.float().mean()),
         mean_cost_ratio=float((res.cost / cost0).mean()),
         per_pass_s={k: v / passes for k, v in spent.items()},
         per_pass_other_s=(solve_s - sum(spent.values())) / passes,
         f64={"passes": passes64, "launches": counts64,
              "solve_s": solve64_s},
         scan=dict(scan, solve_s=scan_s, after_first_pass=first_pass))
    return {name32: counts[name32], name64: counts64[name64]}


def phase_rbd_dual(case, device):
    """The free-flying dual arm (n=36, m=18): every pass launches the
    batch-last entry of the ``(36, 18)`` instantiation, in ``riccati_xl.cu``.
    See :func:`free_flying_arm`."""

    return free_flying_arm("rbd_dual", case, "riccati_xl", device)


def phase_rbd_five(case, device):
    """The free-flying five-arm (n=72, m=36), at the dual arm's B, T and
    budget: every pass launches the batch-last entry of the ``(72, 36)``
    instantiation, in ``riccati_cluster.cu``, a cluster of blocks a lane.
    See :func:`free_flying_arm`."""

    return free_flying_arm("rbd_five", case, "riccati_cluster", device)


def free_flying_arm(phase, case, source, device):
    """A free-flying arm at DUAL's B and T (64 and 50), float32, through
    ``batch_solve(engine="fused")`` (``make_batch_solver``'s function) with
    ``backward_backend="pallas"``, from the open-loop rollout of zero
    controls, rolled out once and given as ``warm_xs``: every pass launches
    the batch-last entry of the arm's instantiation.  First the kernel on
    the local models of that rollout (what the solve's first launch is
    handed), against the plain version (F32_REL_BOUND_RBD of
    each output's largest magnitude), timed beside its bound, with its copy
    path, shared bytes, and blocks an SM (``riccati_xl.cu``) or blocks a
    lane and clusters resident (``riccati_cluster.cu``).  Then the solve,
    ``max_iter`` cut from the first pass's time to DUAL_BUDGET_S (printed; a
    rollout's time stands for the pass's where it alone leaves
    ``min_iter``),
    the launches set to 0 before and read after; and the same solve with
    ``"scan"``: status equal on every lane, ``us`` of the lanes on the same
    iteration count within the 6-DoF bars (median lane
    F32_SOLVE_MEDIAN_BOUND_RBD, worst lane and worst cost
    F32_SOLVE_COST_BOUND_RBD).  Returns ``({kernel: launches}, the kernel's
    row)``."""

    from ilqr_tpu_torch import batched
    from ilqr_tpu_torch.ops import _build, cuda_riccati
    from ilqr_tpu_torch.ops.cuda_riccati import (riccati_scan_cuda_bl,
                                                 riccati_scan_plain_bl)
    from ilqr_tpu_torch.parallel.batching import batch_solve

    problem = case[0]
    n, m = problem.state_dim, problem.control_dim
    spec, budget_s = DUAL, DUAL_BUDGET_S
    B, T = spec["B"], spec["T"]
    name = cuda_riccati.kernel_name(n, m, torch.float32)
    assert cuda_riccati.route(n, m) == (source, n, m)

    # The open-loop rollout the solves start from (given to both as
    # warm_xs, so that neither rolls it out again: at the five-arm's width a
    # rollout takes 15 s on an H100) and its local models, what the solve's
    # first launch is handed.
    x0s, us0 = rbd_inputs(case, B, T, torch.float32, 81, device)
    us_bl = us0.movedim(0, -1).contiguous()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xs0 = batched.rollout_bl(problem, x0s.T.contiguous(), us_bl)
    torch.cuda.synchronize()
    rollout_s = time.perf_counter() - t0
    cost0 = batched.total_cost_bl(problem, xs0, us_bl)
    warm_xs = xs0.movedim(-1, 0).contiguous()

    models = batched.derivatives_bl(problem, xs0, us_bl)
    reg = torch.full((B,), 1.0, dtype=torch.float32, device=device)
    kern = riccati_scan_cuda_bl(*models, reg)
    path = last_copy_path()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    plain = riccati_scan_plain_bl(*models, reg)
    b.record()
    torch.cuda.synchronize()
    max_abs, max_rel = hold(kern, plain, F32_REL_BOUND_RBD)
    bound_ms, bound_by = riccati_bound_ms(T, B, torch.float32, n, m)
    library = cuda_riccati.library_and_symbol(n, m, torch.float32)[0]
    row = dict(B=B, T=T, max_abs_err=max_abs, max_rel_err=max_rel,
               rel_bound=F32_REL_BOUND_RBD, copy_path=path,
               plan_bytes=(_build.load(library)
                           .riccati_cuda_instance_shared_bytes()),
               resident_blocks_per_sm=resident_blocks(_build, library,
                                                      source),
               cluster=cluster_info(_build, library, source),
               ms=device_time(lambda: riccati_scan_cuda_bl(*models, reg), 30),
               call_ms=sync_time(lambda: riccati_scan_cuda_bl(*models, reg),
                                 30),
               plain_ms=a.elapsed_time(b), bound_ms=bound_ms,
               bound_by=bound_by, library_ms=None)
    del models, kern, plain

    def run(cfg):
        return timed_call(lambda: batch_solve(
            problem, x0s, us0, config=cfg, warm_xs=warm_xs, engine="fused",
            device=device))

    # A later pass climbs more rungs than the first: count it 2.5 times,
    # and the scan twin as one more solve.
    def cap(pass_s):
        return max(spec["min_iter"], min(spec["max_iter"], int(
            budget_s / (2 * 2.5 * pass_s))))

    # A pass rolls out at least once: where one rollout alone caps max_iter
    # at min_iter, no pass is spent on timing the first.
    first = (time_one_pass(problem, rbd_config(spec["max_iter"], T), x0s,
                           us0, xs0)
             if cap(rollout_s) > spec["min_iter"] else None)
    del xs0
    max_iter = cap(rollout_s if first is None else sum(first.values()))
    if max_iter < spec["max_iter"]:
        print(f"chip_smoke: {phase}: max_iter cut from {spec['max_iter']} "
              f"to {max_iter} by the {budget_s} s budget"
              + (f" (one rollout took {rollout_s:.1f} s; the first pass is "
                 "not timed)" if first is None else ""),
              file=sys.stderr, flush=True)
    cfg = rbd_config(max_iter, T)

    cuda_riccati.reset_launch_counts()
    with phase_clock() as spent:
        res, solve_s = run(cfg)
    counts = dict(cuda_riccati.launch_counts)
    passes = int(res.iterations.max())
    by_status = check_rbd_result(res, cost0, B, T, n, m, torch.float32)
    assert counts[name] == passes >= 1, (counts, passes)
    assert sum(counts.values()) == passes, counts

    cuda_riccati.reset_launch_counts()
    ref, scan_s = run(cfg.replace(backward_backend="scan"))
    assert cuda_riccati.launches() == 0
    check_rbd_result(ref, cost0, B, T, n, m, torch.float32)
    assert torch.equal(res.status, ref.status), (res.status, ref.status)
    scan = compare_backends(res, ref, F32_SOLVE_COST_BOUND_RBD)

    emit(phase=phase, B=B, T=T, n=n, m=m, dtype="float32",
         source=SOURCE_FILES[source], max_iter=max_iter,
         max_iter_config=spec["max_iter"], budget_s=budget_s,
         rollout_s=rollout_s, first_pass_s=first, passes=passes,
         launches=counts,
         solve_s=solve_s, lanes_by_status=by_status,
         mean_iterations=float(res.iterations.float().mean()),
         mean_cost_ratio=float((res.cost / cost0).mean()),
         per_pass_s={k: v / passes for k, v in spent.items()},
         per_pass_other_s=(solve_s - sum(spent.values())) / passes,
         kernel_at_main_path_shapes={name: row},
         scan=dict(scan, solve_s=scan_s, status_equal=True))
    return {name: counts[name]}, {name: row}


# ---------------------------------------------------------------------------
# The third path: the per-scenario solver on leading batch axes (where the
# JAX package vmaps it), which reaches the kernel's batch-first entry.
# ---------------------------------------------------------------------------

BATCH_FIRST_REPLACES = "ilqr_tpu/ops/pallas_riccati.py:284"
BATCH_FIRST_ENTRY = "ilqr_tpu_torch/ops/cuda_riccati.py::riccati_scan_cuda_batched"
# The batch-first entry at each instantiation: (n, m), B, T.
BATCH_FIRST_SHAPES = (((4, 2), 4096, 100), ((16, 8), 256, 100),
                      ((24, 12), 64, 50))
# Ragged batches of the wide kernel's batch-first read, T=24: an odd B on
# TMA, whose last block's box of two lanes runs one lane past B, and B=1,
# fewer lanes than a box, on the per-element path (a single leading axis
# of the per-scenario solver sends B=1); batch-last, each of these widths
# takes the per-element path.
RAGGED_BATCH_FIRST = (((24, 12), 67), ((16, 8), 65), ((16, 8), 1))
# Seconds the float32 vmap solve may take over its two runs: caps max_iter
# from the time of its first pass, as SOLVE_BUDGET_S does.
VMAP_BUDGET_S = 60.0
# bench.py's MPC shapes: --config mpc (one scenario) and --config mpc_batch.
MPC = dict(B=1024, H=50, n_steps=50)
# Seconds each MPC run may take; n_steps is cut to fit (and the cut printed).
# Cut from 30 s with rbd_dual, and to 10 s with rbd_five, so that the script
# fits its time.
MPC_BUDGET_S = 10.0
# Float64 `us` of the per-scenario solve, card (kernel) against CPU (plain
# version), relative to max|us|.
F64_VMAP_PARITY_REL_BOUND = 1e-10
# The oracle's golden trajectory (tests/test_fixtures.py holds the JAX
# solve to it the same way).
FIXTURE = "tests/fixtures/two_link_T100.npz"
FIXTURE_U_BOUND = 1e-6
FIXTURE_COST_RTOL = 1e-9


def batch_first_models(problem_or_case, n, B, T, dtype, device):
    """Local models as a batched caller hands them over: contiguous
    batch-first ``[B, T, ...]`` / ``[B, ...]``."""

    if n == N:
        models = local_models(problem_or_case, B, T, dtype, 90, device)
    else:
        models = rbd_local_models(problem_or_case, B, T, torch.float32, 91,
                                  device)[0]
        models = tuple(x.to(dtype) for x in models)
    return tuple(x.movedim(-1, 0).contiguous() for x in models)


def phase_batched_entry(problem, cases, device):
    """``riccati_scan_cuda_batched`` at each instantiation: equal to the
    batch-last entry on the transposed inputs (the same arithmetic a lane in
    both layouts, so ``torch.equal``), within the bounds of the kernel checks
    of the plain version, contiguous outputs, and no device memory allocated
    beyond its outputs; then the time of the entry beside the batch-last
    kernel's.  The entry copies no layout (the kernels read ``[B, T, ...]``
    in place), so there is no copy to time.  Then the wide kernel at the
    ragged batches of ``RAGGED_BATCH_FIRST``, both types, held the same way
    (float64 elementwise, as ``check_kernel``), with the copy path each
    launch reports.  (:func:`batch_first_rows` holds and times a shape.)"""

    from ilqr_tpu_torch.ops.cuda_riccati import (from_batch_last,
                                                 riccati_scan_cuda_batched,
                                                 riccati_scan_cuda_bl,
                                                 riccati_scan_plain_batched,
                                                 to_batch_last)

    rows = {}
    for (n, m), B, T in BATCH_FIRST_SHAPES:
        source = problem if n == N else cases[n == 24]
        m32 = batch_first_models(source, n, B, T, torch.float32, device)
        rows.update(batch_first_rows(
            m32, n, m, B, T, F32_REL_BOUND if n == N else F32_REL_BOUND_RBD))
        del m32

    ragged = {}
    for (n, m), B in RAGGED_BATCH_FIRST:
        m32 = batch_first_models(cases[n == 24], n, B, 24, torch.float32,
                                 device)
        for dtype in (torch.float32, torch.float64):
            bf = tuple(x.to(dtype) for x in m32)
            reg = torch.logspace(-3, 0, B, dtype=dtype, device=device)
            got = riccati_scan_cuda_batched(*bf, reg)
            path_bf = last_copy_path()
            same = from_batch_last(riccati_scan_cuda_bl(*to_batch_last(bf),
                                                        reg))
            path_bl = last_copy_path()
            plain = riccati_scan_plain_batched(*bf, reg)
            torch.cuda.synchronize()
            assert path_bf == ("tma" if B >= 2 else "per_element"), path_bf
            assert path_bl == "per_element", path_bl
            max_abs, max_rel = 0.0, 0.0
            for name, g, e, p in zip(("duffs", "Ks", "dv1", "dv2"), got,
                                     same, plain):
                assert g.shape == p.shape and g.shape[0] == B, name
                assert g.is_contiguous(), name
                assert torch.equal(g, e), f"{name}: batch-first != batch-last"
                assert bool(torch.isfinite(g).all()), f"{name}: not finite"
                r = rel_err(g, p)
                if dtype == torch.float64:
                    rtol, atol = (1e-10, 1e-12) if g.ndim > 1 else (1e-9, 0.0)
                    torch.testing.assert_close(g, p, rtol=rtol, atol=atol,
                                               msg=lambda s: f"{name}: {s}")
                else:
                    assert r <= F32_REL_BOUND_RBD, ((n, m), B, name, r)
                max_abs = max(max_abs, float((g - p).abs().max()))
                max_rel = max(max_rel, r)
            ragged[f"{n}x{m}_B{B}_T24_{str(dtype)[6:]}"] = dict(
                copy_path_batch_first=path_bf, copy_path_batch_last=path_bl,
                equal_to_batch_last=True, max_abs_err=max_abs,
                max_rel_err=max_rel)
            del got, same, plain, bf
        del m32
    emit(phase="batched_entry", entry=BATCH_FIRST_ENTRY,
         outputs="contiguous batch-first, written by the kernel",
         f64_rel_bound=1e-10, f32_rel_bound=F32_REL_BOUND,
         f32_rel_bound_wide=F32_REL_BOUND_RBD, rows=rows, ragged=ragged)
    return rows


def count_batch_first(name):
    """Launches of the batch-first entry at ``name`` since the last reset;
    asserts that no other kernel launched."""

    from ilqr_tpu_torch.ops import cuda_riccati

    counts = dict(cuda_riccati.batched_launch_counts)
    assert sum(cuda_riccati.launch_counts.values()) == 0, (
        cuda_riccati.launch_counts)
    assert sum(counts.values()) == counts.get(name, 0), counts
    return counts.get(name, 0)


def phase_vmap_solve(problem, cfg, fused, device):
    """``make_batch_solver(engine="vmap")`` at the first path's full width
    with phase ``solve``'s config (``cfg``) and against its fused result
    (``fused``), then a float64 card-against-CPU check."""

    from ilqr_tpu_torch.config import Status
    from ilqr_tpu_torch.ops import cuda_riccati
    from ilqr_tpu_torch.parallel.batching import (batch_metrics,
                                                  make_batch_solver)

    B, T = HEADLINE["B"], HEADLINE["T"]
    x0s, us0 = scenario_inputs(B, T, torch.float32, 0, device)
    name = cuda_riccati.kernel_name(N, M, torch.float32)

    def run(cfg_run, x0s_run, us0_run, dev=device):
        solve_fn = make_batch_solver(problem, cfg_run, engine="vmap",
                                     device=dev)
        if dev != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve_fn(x0s_run, us0_run)
        if dev != "cpu":
            torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    # One pass first: cap max_iter if the two runs below would not fit.
    _, one_s = run(cfg.replace(max_iter=1), x0s, us0)
    cap = max(3, min(cfg.max_iter, int(VMAP_BUDGET_S / (2 * 1.5 * one_s))))
    cfg_v = cfg.replace(max_iter=cap)

    # The path: counts set to 0 just before, read just after.
    cuda_riccati.reset_launch_counts()
    res, solve_s = run(cfg_v, x0s, us0)
    launches = count_batch_first(name)
    passes = int(res.iterations.max())
    assert launches == passes >= 1, (launches, passes)
    assert res.us.shape == (B, T, M) and res.us.dtype == torch.float32
    ok = ((res.status == int(Status.CONVERGED))
          | (res.status == int(Status.MAX_ITER)))
    assert bool(ok.all()), res.status.unique().tolist()
    for f in (res.xs, res.us, res.cost):
        assert bool(torch.isfinite(f).all())

    # Against the fused engine on the same inputs.
    same_it = res.iterations == fused.iterations
    frac_same = float(same_it.float().mean())
    assert frac_same >= 0.98, frac_same
    assert bool((res.status == fused.status)[same_it].all())
    us_rel = float((res.us[same_it] - fused.us[same_it]).abs().max()
                   / fused.us.abs().max())
    assert us_rel <= F32_SOLVE_REL_BOUND, us_rel

    # Once more with each phase timed.
    with phase_clock(per_scenario_phases()) as spent:
        res2, timed_s = run(cfg_v, x0s, us0)
    assert torch.equal(res2.status, res.status)

    # Float64 at a small size: card (kernel) against CPU (plain version).
    x64, u64 = scenario_inputs(8, 24, torch.float64, 40, "cpu")
    cfg64 = cfg.replace(max_iter=20)
    cpu, _ = run(cfg64, x64, u64, "cpu")
    name64 = cuda_riccati.kernel_name(N, M, torch.float64)
    cuda_riccati.reset_launch_counts()
    gpu, _ = run(cfg64, x64, u64)
    launches64 = count_batch_first(name64)
    passes64 = int(gpu.iterations.max())
    assert launches64 == passes64 >= 1, (launches64, passes64)
    assert torch.equal(cpu.status, gpu.status.cpu())
    assert torch.equal(cpu.iterations, gpu.iterations.cpu())
    us64_rel = float((gpu.us.cpu() - cpu.us).abs().max() / cpu.us.abs().max())
    assert us64_rel <= F64_VMAP_PARITY_REL_BOUND, us64_rel

    metrics = {k: float(v) for k, v in batch_metrics(res).items()}
    emit(phase="vmap_solve", B=B, T=T, n=N, m=M, dtype="float32",
         engine="vmap", max_iter_cap=cap, max_iter_config=cfg.max_iter,
         one_pass_s=one_s, passes=passes, batch_first_launches={name: launches},
         solve_s=solve_s, solves_per_s=B / solve_s,
         lanes_converged=int(metrics["n_converged"]),
         mean_iterations=metrics["mean_iterations"],
         per_pass_s={k: v / passes for k, v in spent.items()},
         per_pass_other_s=(timed_s - sum(spent.values())) / passes,
         timed_solve_s=timed_s,
         fused={"lanes_same_iterations": frac_same,
                "us_rel_diff_same_lanes": us_rel,
                "bound": F32_SOLVE_REL_BOUND},
         f64={"B": 8, "T": 24, "passes": passes64,
              "batch_first_launches": {name64: launches64},
              "status": cpu.status.tolist(),
              "iterations": cpu.iterations.tolist(),
              "us_rel_diff_card_vs_cpu": us64_rel,
              "bound": F64_VMAP_PARITY_REL_BOUND})
    return {name: launches, name64: launches64}


def phase_single(problem, device):
    """One scenario, no batch axis: the float64 ``solve`` of the oracle's
    golden trajectory on the card, then the latency of one float32 solve at
    T=100 (``bench.py --config single``)."""

    import pathlib

    import numpy as np

    from ilqr_tpu_torch.config import ILQRConfig, Status
    from ilqr_tpu_torch.problem import problem_dynamics, rollout
    from ilqr_tpu_torch.solver import solve

    fx = np.load(pathlib.Path(__file__).resolve().parent / FIXTURE)
    iters = int(fx["iterations"])
    assert bool(fx["converged"])
    res = solve(problem, torch.as_tensor(fx["xs0"]),
                torch.as_tensor(fx["us0"]),
                config=ILQRConfig(max_iter=iters + 50, tol=float(fx["tol"])),
                device=device)
    u_err = float((res.us.cpu() - torch.as_tensor(fx["us_ref"])).abs().max())
    cost_rel = abs(float(res.cost) - float(fx["cost_ref"])) / abs(
        float(fx["cost_ref"]))
    assert res.us.device.type == torch.device(device).type
    assert res.us.dtype == torch.float64
    assert u_err < FIXTURE_U_BOUND, u_err
    assert int(res.iterations) == iters, (int(res.iterations), iters)
    assert cost_rel <= FIXTURE_COST_RTOL, cost_rel

    T = 100
    cfg = ILQRConfig(max_iter=30, tol=1e-5, tol_grad=1e-10)
    x0 = torch.tensor([0.1, -0.1, 0.0, 0.0], dtype=torch.float32,
                      device=device)
    us0 = torch.zeros((T, M), dtype=torch.float32, device=device)
    xs0 = rollout(lambda x, u: problem_dynamics(problem, x, u), x0, us0)
    times = []
    # The first call and two warm ones (three warm ones until the phases of
    # bench.py's strict, rbd --ls-*, mpc_batch --problem rbd and the DDP A/B
    # came, so that the script fits its time).
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = solve(problem, xs0, us0, config=cfg, device=device)
        status = int(r.status)
        times.append(time.perf_counter() - t0)
    assert status in (int(Status.CONVERGED), int(Status.MAX_ITER)), status
    assert bool(torch.isfinite(r.us).all()) and r.us.dtype == torch.float32
    emit(phase="single", fixture=FIXTURE, fixture_iterations=iters,
         fixture_us_max_abs_err=u_err, fixture_bound=FIXTURE_U_BOUND,
         fixture_cost_rel_diff=cost_rel, fixture_cost_rtol=FIXTURE_COST_RTOL,
         latency_T=T, latency_dtype="float32",
         latency_s_warm_median=statistics.median(times[1:]),
         latency_s_all=times, iterations=int(r.iterations), status=status)


def phase_mpc(problem, device):
    """``mpc_run`` with ``bench.py --config mpc``'s shape, then
    ``batch_mpc_run`` with ``--config mpc_batch``'s, the latter with the
    kernel (``backward_backend="pallas"``): every replan's backward passes
    go through the batch-first entry.  ``n_steps`` is cut to MPC_BUDGET_S
    from the time of a two-step run."""

    from ilqr_tpu_torch.config import ILQRConfig
    from ilqr_tpu_torch.ops import cuda_riccati
    from ilqr_tpu_torch.parallel.mpc import batch_mpc_run, mpc_run

    H, STEPS = MPC["H"], MPC["n_steps"]
    out = {}

    def run(fn, x0, n_steps, cfg):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn(problem, x0, H, n_steps, cfg, device=device)
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0

    def check(r, n_steps, lead):
        assert r.us.shape == lead + (n_steps, M)
        assert r.xs.shape == lead + (n_steps + 1, N)
        for f in (r.xs, r.us, r.costs):
            assert bool(torch.isfinite(f).all())
        return lanes_by_status(r.statuses)

    x0 = torch.tensor([0.1, -0.1, 0.0, 0.0], dtype=torch.float32,
                      device=device)
    gen = torch.Generator(device="cpu").manual_seed(5)
    x0s = (x0.cpu() + 0.1 * torch.randn((MPC["B"], N), generator=gen)
           ).to(device)
    name = cuda_riccati.kernel_name(N, M, torch.float32)
    for tag, fn, x, cfg in (
            ("mpc", mpc_run, x0,
             ILQRConfig(max_iter=10, tol=1e-5, tol_grad=1e-10)),
            ("mpc_batch", batch_mpc_run, x0s,
             ILQRConfig(max_iter=10, tol=1e-5, tol_grad=1e-10,
                        tol_grad_rel=1e-6, backward_backend="pallas"))):
        _, two_s = run(fn, x, 2, cfg)
        n_steps = max(2, min(STEPS, int(MPC_BUDGET_S / (two_s / 2))))
        cuda_riccati.reset_launch_counts()
        r, total_s = run(fn, x, n_steps, cfg)
        lead = tuple(x.shape[:-1])
        statuses = check(r, n_steps, lead)
        row = dict(B=x.shape[0] if lead else 1, horizon=H,
                   n_steps=n_steps, n_steps_config=STEPS,
                   backward_backend=cfg.backward_backend,
                   total_s=total_s, ms_per_replan=total_s / n_steps * 1e3,
                   statuses=statuses,
                   mean_iterations=float(r.iterations.float().mean()))
        if lead:
            launches = count_batch_first(name)
            passes = int(r.iterations.max(dim=0).values.sum())
            assert launches == passes >= n_steps, (launches, passes)
            row.update(batch_first_launches={name: launches},
                       passes=passes,
                       scenario_replans_per_s=x.shape[0] * n_steps / total_s)
            out[name] = launches
        else:
            # One scenario runs the scan, as in the JAX package.
            assert cuda_riccati.launches() == 0
        if n_steps < STEPS:
            print(f"chip_smoke: {tag}: n_steps cut from {STEPS} to {n_steps} "
                  f"by the {MPC_BUDGET_S} s budget", file=sys.stderr,
                  flush=True)
        emit(phase=tag, **row)
    return out


# ---------------------------------------------------------------------------
# The fifth slice: snapshots, resume and retry; checkpointed fleet MPC; the
# parallel-in-time backward pass at T=1000; the parallel-alpha ladder; the
# augmented Lagrangian; traces and profiling.
# ---------------------------------------------------------------------------

# Files the new phases write (git-ignored, inside the checkout).
SCRATCH = "build/chip_smoke"
MPC_CHUNKED = dict(B=1024, H=50, step_chunk=2)
MPC_CHUNKED_BUDGET_S = 10.0
# bench.py --config long_horizon: B=256, T=1000, max_iter=15, three backends.
LONG = dict(B=256, T=1000, max_iter=15)
# Seconds the three long-horizon solves may take together; caps max_iter.
# Cut from 120 s (4 passes) to 60 s with RBD["max_iter_cut"], and to 30 s
# (1 pass on an H100: the one-pass solves that time it are then the
# phase's) with the phases of bench.py's strict, rbd --ls-*, mpc_batch
# --problem rbd and the DDP A/B, for the same reason.
LONG_BUDGET_S = 30.0
# Float64 associative backward pass, card against the plain torch pit on
# the CPU: the rtol of tests/test_torch_pit.py.
LONG_F64 = dict(B=8, T=200, rtol=1e-9)
PARALLEL_ALPHA_BLOCKS = (4, 8)
# The largest |us| difference of the parallel-alpha solve from the
# sequential one, relative to max|us|, where the card's batched shapes round
# differently (printed; 0 where they agree bit for bit).
PARALLEL_ALPHA_REL_BOUND = 1e-6
# al_solve of the 2-link: a control box by squashing, a joint-velocity cap
# by the augmented Lagrangian.  Without the cap the swing-up's joints reach
# about 3 rad/s and its torques stay under 1.5.  Inner solves of at most 10
# passes with adaptive regularization: with a fixed reg their ladders run out
# against the penalty's kinks (the JAX package's al_solve does the same).
# A ladder of 4 rungs: a ladder that runs out raises reg for the next pass,
# and with the default 32 rungs one such lane makes the whole batch roll out
# 32 times (ROADMAP.md C12), which here happens nearly every pass.
# T cut from 100 to 50 with the phases of bench.py's strict, rbd --ls-*,
# mpc_batch --problem rbd and the DDP A/B (93 s at T=100 on an H100, a
# host-bound pass a time step), so that the script fits its time.
AL = dict(B=1024, T=50, T_uncut=100, u_max=1.5, v_max=2.5, max_outer=10,
          max_iter=10, max_backtracks=4)
AL_F64 = dict(B=4, T=24, rtol=1e-8)
TRACE = dict(T=50, max_iter=15)


class Killed(Exception):
    """Stands for whatever ends a process in the middle of a solve."""


class FaultAt:
    """``_fault_hook``: raises ``exc`` once, before chunk ``at``."""

    def __init__(self, at, exc):
        self.at, self.exc, self.calls = at, exc, []

    def __call__(self, chunk_idx):
        self.calls.append(chunk_idx)
        if chunk_idx == self.at and self.calls.count(self.at) == 1:
            raise self.exc


def scratch_path(name):
    """A fresh path under SCRATCH (an earlier run's file or directory of the
    name removed)."""

    import pathlib
    import shutil

    d = pathlib.Path(__file__).resolve().parent / SCRATCH
    d.mkdir(parents=True, exist_ok=True)
    path = d / name
    if path.is_dir():
        shutil.rmtree(path)
    elif path.exists():
        path.unlink()
    return path


def phase_resilience(problem, cfg, device):
    """Phase ``solve``'s chunked solve (B=4096, T=100, float32,
    ``iter_chunk=2``), uninterrupted, against the same solve with a device
    error injected before chunk 2 and retried from a host snapshot, and
    against the same solve killed before chunk 2 and resumed from its
    snapshot file by a fresh solver: ``torch.equal`` in ``us``, ``status``
    and ``iterations``; then all of it again with compaction."""

    from ilqr_tpu_torch.batched import make_chunked_batch_solver, rollout_bl
    from ilqr_tpu_torch.ops import cuda_riccati

    B, T = HEADLINE["B"], HEADLINE["T"]
    x0s, us0 = scenario_inputs(B, T, torch.float32, 0, device)
    xs0 = rollout_bl(problem, x0s.T.contiguous(),
                     us0.movedim(0, -1).contiguous()).movedim(-1, 0)
    xs0 = xs0.contiguous()
    name = cuda_riccati.kernel_name(N, M, torch.float32)

    def solve(**kw):
        solve_fn = make_chunked_batch_solver(problem, cfg, iter_chunk=2,
                                             device=device, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve_fn(xs0, us0)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    def same(a, b):
        for f in ("us", "status", "iterations"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
        return True

    out = {}
    launches = 0
    for tag, sizes in (("full", ()), ("compacted", COMPACT_SIZES)):
        ref, ref_s = solve(compact_sizes=sizes)
        # The path under test is the retried, the killed and the resumed
        # solve: counts set to 0 after the reference, read after the resume.
        cuda_riccati.reset_launch_counts()
        hook = FaultAt(2, torch.AcceleratorError("injected device error"))
        retried, retried_s = solve(compact_sizes=sizes, snapshot_every=1,
                                   _fault_hook=hook)
        assert hook.calls.count(2) == 2, hook.calls
        same(retried, ref)
        path = scratch_path(f"resilience_{tag}.npz")
        try:
            solve(compact_sizes=sizes, snapshot_path=str(path),
                  _fault_hook=FaultAt(2, Killed()))
            raise AssertionError("the injected kill did not stop the solve")
        except Killed:
            pass
        assert path.exists()
        resumed, resumed_s = solve(compact_sizes=sizes,
                                   snapshot_path=str(path))
        assert not path.exists()
        counts = dict(cuda_riccati.launch_counts)
        assert counts[name] >= 1 and sum(counts.values()) == counts[name], (
            tag, counts)
        launches += counts[name]
        same(resumed, ref)
        out[tag] = dict(compact_sizes=list(sizes), launches=counts[name],
                        solve_s=ref_s,
                        retried_solve_s=retried_s, resumed_solve_s=resumed_s,
                        passes=int(ref.iterations.max()),
                        retry_equal=True, resume_equal=True,
                        file_left_by_the_kill=True,
                        file_removed_after_resume=True)
    emit(phase="resilience", B=B, T=T, dtype="float32", iter_chunk=2,
         fault_at_chunk=2, launches={name: launches}, **out)
    return {name: launches}


def phase_mpc_chunked(problem, device):
    """``batch_mpc_run_chunked`` (B=1024, H=50, the kernel on): ``n_steps``
    cut to a budget, in chunks of ``step_chunk``; stopped after the first
    chunk and resumed from its checkpoint; equal (``torch.equal``) to
    ``batch_mpc_run`` at the same ``n_steps``."""

    from ilqr_tpu_torch.config import ILQRConfig
    from ilqr_tpu_torch.ops import cuda_riccati
    from ilqr_tpu_torch.parallel.mpc import (batch_mpc_run,
                                             batch_mpc_run_chunked)

    B, H, chunk = MPC_CHUNKED["B"], MPC_CHUNKED["H"], MPC_CHUNKED["step_chunk"]
    cfg = ILQRConfig(max_iter=10, tol=1e-5, tol_grad=1e-10,
                     tol_grad_rel=1e-6, backward_backend="pallas")
    x0 = torch.tensor([0.1, -0.1, 0.0, 0.0], dtype=torch.float32)
    gen = torch.Generator(device="cpu").manual_seed(5)
    x0s = (x0 + 0.1 * torch.randn((B, N), generator=gen)).to(device)
    name = cuda_riccati.kernel_name(N, M, torch.float32)

    def timed(fn, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn(problem, x0s, H, *a, **kw)
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0

    # One chunk to size the run: the reference, the stopped run and the
    # resumed one make three runs of n_steps.
    _, chunk_s = timed(batch_mpc_run, chunk, cfg, device=device)
    n_steps = max(2 * chunk, chunk * int(
        MPC_CHUNKED_BUDGET_S / (3 * chunk_s)))
    n_steps = min(n_steps, MPC["n_steps"] // chunk * chunk)
    if n_steps < MPC["n_steps"]:
        print(f"chip_smoke: mpc_chunked: n_steps cut from {MPC['n_steps']} "
              f"to {n_steps} by the {MPC_CHUNKED_BUDGET_S} s budget",
              file=sys.stderr, flush=True)

    path = scratch_path("mpc_chunked.npz")
    ref, ref_s = timed(batch_mpc_run, n_steps, cfg, device=device)
    # The path under test is the stopped and the resumed run: counts set
    # to 0 after the reference, read after the resume.
    cuda_riccati.reset_launch_counts()
    stops = []
    part, part_s = timed(batch_mpc_run_chunked, n_steps, cfg,
                         step_chunk=chunk, checkpoint_path=str(path),
                         on_chunk=lambda step: stops.append(step) or True,
                         device=device)
    assert stops == [chunk] and path.exists()
    res, resumed_s = timed(batch_mpc_run_chunked, n_steps, cfg,
                           step_chunk=chunk, checkpoint_path=str(path),
                           device=device)
    launches = count_batch_first(name)
    assert launches >= 1, launches
    for f in res._fields:
        assert torch.equal(getattr(res, f), getattr(ref, f)), f
    assert torch.equal(part.us[:, :chunk], ref.us[:, :chunk])
    path.unlink()
    emit(phase="mpc_chunked", B=B, horizon=H, step_chunk=chunk,
         n_steps=n_steps, n_steps_config=MPC["n_steps"],
         budget_s=MPC_CHUNKED_BUDGET_S, backward_backend="pallas",
         batch_first_launches={name: launches},
         equal_to_batch_mpc_run=True, stopped_after_steps=stops,
         resumed_steps=n_steps - chunk,
         ms_per_replan=resumed_s / (n_steps - chunk) * 1e3,
         ms_per_replan_batch_mpc_run=ref_s / n_steps * 1e3,
         first_chunk_s=part_s)
    return {name: launches}


def phase_long_horizon(problem, device):
    """``bench.py --config long_horizon`` (2-link, B=256, T=1000,
    ``max_iter=15``) through ``engine="vmap"`` — ``"associative"`` exists
    in the per-scenario engine only (``ROADMAP.md`` C1) — with ``scan``,
    ``pallas`` and ``associative`` in turn, ``max_iter`` cut to a budget;
    then the float64 associative backward pass on the card against the
    plain torch ``pit`` on the CPU."""

    from ilqr_tpu_torch.backward import backward_pass
    from ilqr_tpu_torch.config import ILQRConfig, Status
    from ilqr_tpu_torch.ops import cuda_riccati
    from ilqr_tpu_torch.parallel.batching import make_batch_solver
    from ilqr_tpu_torch.problem import problem_dynamics, rollout

    B, T = LONG["B"], LONG["T"]
    x0s, us0 = scenario_inputs(B, T, torch.float32, 7, device)
    base = ILQRConfig(max_iter=LONG["max_iter"], tol=1e-5, tol_grad=1e-10,
                      tol_grad_rel=1e-6, reg=1e-2)
    backends = ("scan", "pallas", "associative")

    def run(cfg):
        solve_fn = make_batch_solver(problem, cfg, engine="vmap",
                                     device=device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve_fn(x0s, us0)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    name = cuda_riccati.kernel_name(N, M, torch.float32)

    def solve(backend, max_iter):
        """``(result, seconds, batch-first launches)``; counts set to 0
        just before and read just after."""

        cuda_riccati.reset_launch_counts()
        res, solve_s = run(base.replace(max_iter=max_iter,
                                        backward_backend=backend))
        if backend != "pallas":
            assert cuda_riccati.launches() == 0
            return res, solve_s, 0
        return res, solve_s, count_batch_first(name)

    one = {b: solve(b, 1) for b in backends}
    # A later pass climbs more rungs than the first: count it twice.  Where
    # the budget leaves one pass, the one-pass solves are the phase's.
    cap = max(1, min(LONG["max_iter"],
                     int(LONG_BUDGET_S / (2 * sum(o[1] for o in
                                                  one.values())))))
    if cap < LONG["max_iter"]:
        print(f"chip_smoke: long_horizon: max_iter cut from "
              f"{LONG['max_iter']} to {cap} by the {LONG_BUDGET_S} s budget",
              file=sys.stderr, flush=True)
    rows, results, launches = {}, {}, 0
    for backend in backends:
        res, solve_s, launched = (one[backend] if cap == 1
                                  else solve(backend, cap))
        passes = int(res.iterations.max())
        if backend == "pallas":
            launches = launched
            assert launches == passes >= 1, (launches, passes)
        assert res.us.shape == (B, T, M) and res.us.dtype == torch.float32
        for f in (res.xs, res.us, res.cost):
            assert bool(torch.isfinite(f).all()), backend
        results[backend] = res
        rows[backend] = dict(
            solve_s=solve_s, solves_per_s=B / solve_s, passes=passes,
            one_pass_s=one[backend][1],
            lanes_converged=int((res.status == int(Status.CONVERGED)).sum()),
            mean_cost=float(res.cost.mean()))
    # The kernel against the scan it replaces, over the cut solve.
    same = results["pallas"].iterations == results["scan"].iterations
    rows["pallas"]["us_rel_diff_from_scan_same_lanes"] = float(
        (results["pallas"].us[same] - results["scan"].us[same]).abs().max()
        / results["scan"].us.abs().max())
    rows["pallas"]["lanes_same_iterations_as_scan"] = float(
        same.float().mean())

    # Float64: the associative backward pass on the card against the CPU.
    Bf, Tf = LONG_F64["B"], LONG_F64["T"]
    x64, _ = scenario_inputs(Bf, Tf, torch.float64, 8, "cpu")
    gen = torch.Generator(device="cpu").manual_seed(9)
    u64 = 0.3 * torch.randn((Bf, Tf, M), generator=gen, dtype=torch.float64)
    xs64 = rollout(lambda x, u: problem_dynamics(problem, x, u), x64, u64)
    cfg64 = base.replace(backward_backend="associative")
    cpu = backward_pass(problem, xs64, u64, cfg64)
    gpu = backward_pass(problem, xs64.to(device), u64.to(device), cfg64)
    f64 = {}
    for fname, g, c in zip(cpu._fields, gpu, cpu):
        torch.testing.assert_close(g.cpu(), c, rtol=LONG_F64["rtol"],
                                   atol=1e-12, msg=fname)
        f64[fname] = rel_err(g.cpu(), c)
    emit(phase="long_horizon", B=B, T=T, dtype="float32", engine="vmap",
         engine_reason="'associative' exists only in the per-scenario engine",
         max_iter=cap, max_iter_config=LONG["max_iter"],
         budget_s=LONG_BUDGET_S, backends=rows,
         batch_first_launches={name: launches},
         f64_associative_card_vs_cpu=dict(B=Bf, T=Tf, rtol=LONG_F64["rtol"],
                                          rel_diff=f64))
    return {name: launches}


def phase_parallel_alpha(problem, cfg, seq, device):
    """The fused solve of phase ``solve`` (``seq``, its result with config
    ``cfg``) with ``parallel_alpha_block`` 4, then 8: the same status,
    iterations and alpha on every lane, ``us`` equal (or within
    PARALLEL_ALPHA_REL_BOUND of max|us|, printed); the ladder's seconds and
    rungs a pass beside the sequential ladder's."""

    from ilqr_tpu_torch import batched
    from ilqr_tpu_torch.ops import cuda_riccati
    from ilqr_tpu_torch.parallel.batching import make_batch_solver

    B, T = HEADLINE["B"], HEADLINE["T"]
    x0s, us0 = scenario_inputs(B, T, torch.float32, 0, device)
    name = cuda_riccati.kernel_name(N, M, torch.float32)

    def run(cfg_run):
        """The solve, with the seconds in its ladder and the rollouts the
        ladder ran (a rung each, sequential; R rungs each, parallel)."""

        R = max(cfg_run.parallel_alpha_block, 1)
        ladder = "forward_pass_bl" if R == 1 else "forward_pass_bl_parallel"
        rollouts = [0]
        original = batched.closed_loop_rollout_bl

        def counting(*a, **kw):
            rollouts[0] += 1
            return original(*a, **kw)

        batched.closed_loop_rollout_bl = counting
        try:
            with phase_clock({"ladder": [(batched, ladder)]}) as spent:
                solve_fn = make_batch_solver(problem, cfg_run, engine="fused",
                                             device=device)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = solve_fn(x0s, us0)
                torch.cuda.synchronize()
                solve_s = time.perf_counter() - t0
        finally:
            batched.closed_loop_rollout_bl = original
        passes = int(res.iterations.max())
        return res, dict(solve_s=solve_s, passes=passes,
                         ladder_s_per_pass=spent["ladder"] / passes,
                         rollouts_per_pass=rollouts[0] / passes,
                         rungs_per_pass=R * rollouts[0] / passes)

    seq_again, seq_row = run(cfg)
    for f in ("us", "status", "iterations", "alpha"):
        assert torch.equal(getattr(seq_again, f), getattr(seq, f)), f
    rows, launches = {"sequential": seq_row}, 0
    for R in PARALLEL_ALPHA_BLOCKS:
        cuda_riccati.reset_launch_counts()
        res, row = run(cfg.replace(parallel_alpha_block=R))
        counts = dict(cuda_riccati.launch_counts)
        assert counts[name] == row["passes"] >= 1, (counts, row)
        launches += counts[name]
        for f in ("status", "iterations", "alpha"):
            assert torch.equal(getattr(res, f), getattr(seq, f)), (R, f)
        us_rel = float((res.us - seq.us).abs().max() / seq.us.abs().max())
        assert us_rel <= PARALLEL_ALPHA_REL_BOUND, (R, us_rel)
        row.update(us_equal=bool(torch.equal(res.us, seq.us)),
                   us_rel_diff=us_rel, launches=counts[name])
        rows[f"R={R}"] = row
    emit(phase="parallel_alpha", B=B, T=T, dtype="float32",
         blocks=list(PARALLEL_ALPHA_BLOCKS), us_rel_bound=PARALLEL_ALPHA_REL_BOUND,
         rows=rows)
    return {name: launches}


def al_problem(problem):
    """The 2-link squashed into the control box |u| < AL["u_max"], and the
    joint-velocity cap |dq| <= AL["v_max"] as constraint rows."""

    from ilqr_tpu_torch.constraints import box_constrained

    squashed, to_u, to_v = box_constrained(problem, -AL["u_max"], AL["u_max"])

    def cap(x, v):
        vmax = torch.as_tensor(AL["v_max"], dtype=x.dtype, device=x.device)
        return torch.cat([x[2:] - vmax, -x[2:] - vmax])

    return squashed, to_u, cap


def al_inputs(B, T, dtype, seed, device):
    """The swing-up's starts (the scenario distribution of phase ``solve``)
    and zero pre-controls."""

    gen = torch.Generator(device="cpu").manual_seed(seed)
    x0s = (torch.tensor(NOMINAL, dtype=torch.float64)
           + 0.1 * torch.randn((B, N), generator=gen, dtype=torch.float64))
    return (x0s.to(dtype).to(device),
            torch.zeros((B, T, M), dtype=dtype, device=device))


def phase_al(problem, device):
    """``al_solve`` of the 2-link with a control box and a velocity cap,
    B=1024, T=50 (cut from 100, printed), float32,
    ``backward_backend="pallas"``: the index coordinate makes the state
    n=5, so every inner backward pass launches
    the batch-first entry of ``riccati.cu`` at ``(5, 2)``.  The largest
    violation must end at or below the ALConfig target; then float64 at B=4,
    card against CPU; then the ``(5, 2)`` kernel at the phase's shapes
    against its plain version."""

    import functools

    from ilqr_tpu_torch import al
    from ilqr_tpu_torch.config import ILQRConfig
    from ilqr_tpu_torch.derivatives import (problem_linearize,
                                            problem_quadratize_final,
                                            problem_quadratize_running)
    from ilqr_tpu_torch.ops import cuda_riccati
    from ilqr_tpu_torch.problem import problem_dynamics, rollout

    squashed, to_u, cap = al_problem(problem)
    cfg = ILQRConfig(max_iter=AL["max_iter"], tol=1e-5, tol_grad=1e-10,
                     tol_grad_rel=1e-6, reg=1e-2, adaptive_reg=True,
                     max_backtracks=AL["max_backtracks"],
                     backward_backend="pallas")
    alc = al.ALConfig(max_outer=AL["max_outer"])
    B, T = AL["B"], AL["T"]
    print(f"chip_smoke: al: T cut from {AL['T_uncut']} to {T}, so that the "
          f"script fits its time", file=sys.stderr, flush=True)
    x0s, us0 = al_inputs(B, T, torch.float32, 11, device)

    def run(x0, u0, dev, cfg_run):
        if dev != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = al.al_solve(squashed, x0, u0, cap, config=cfg_run, al_config=alc,
                        device=dev)
        if dev != "cpu":
            torch.cuda.synchronize()
        return r, time.perf_counter() - t0

    n_aug = N + 1
    name = cuda_riccati.kernel_name(n_aug, M, torch.float32)
    cuda_riccati.reset_launch_counts()
    res, solve_s = run(x0s, us0, device, cfg)
    launches = count_batch_first(name)
    assert launches >= int(res.outer_iterations.max()) >= 1, launches
    viol = float(res.max_violation.max())
    assert viol <= alc.constraint_tol, (viol, alc.constraint_tol)
    assert res.us.dtype == torch.float32
    assert bool(torch.isfinite(res.us).all())
    # Inside the box: strictly in exact arithmetic, up to the bound itself
    # where float32 tanh rounds to 1.
    u = to_u(res.us)
    assert float(u.abs().max()) <= AL["u_max"]
    by_status = lanes_by_status(res.status)

    # Float64 at a small size: card (kernel at (5, 2)) against CPU.
    Bf, Tf = AL_F64["B"], AL_F64["T"]
    x64, u64 = al_inputs(Bf, Tf, torch.float64, 12, "cpu")
    cpu, cpu_s = run(x64, u64, "cpu", cfg)
    name64 = cuda_riccati.kernel_name(n_aug, M, torch.float64)
    cuda_riccati.reset_launch_counts()
    gpu, _ = run(x64, u64, device, cfg)
    launches64 = count_batch_first(name64)
    for f in ("outer_iterations", "inner_iterations", "status"):
        assert torch.equal(getattr(gpu, f).cpu(), getattr(cpu, f)), f
    f64 = {}
    for f in ("us", "lam", "mu", "cost"):
        torch.testing.assert_close(getattr(gpu, f).cpu(), getattr(cpu, f),
                                   rtol=AL_F64["rtol"], atol=1e-10, msg=f)
        f64[f] = rel_err(getattr(gpu, f).cpu(), getattr(cpu, f))

    # The (5, 2) kernel at this phase's shapes, on what its first launch was
    # handed: the local models of the first augmented problem (multipliers
    # 0, penalty mu0) at the rollout of zero pre-controls.  (Later iterates
    # of the squashed problem may hand it an indefinite Ruu, whose lanes the
    # line search rejects.)
    lanes = torch.arange(B, device=device)
    prob_al = al._augment_problem(
        squashed, cap, None,
        torch.zeros((B * T, 4), dtype=torch.float32, device=device),
        torch.zeros((B, 1), dtype=torch.float32, device=device),
        torch.full((B,), alc.mu0, dtype=torch.float32, device=device),
        torch.zeros(4, dtype=torch.bool, device=device),
        torch.zeros(1, dtype=torch.bool, device=device), T)
    x0_aug = torch.cat([x0s, (lanes * T).to(torch.float32)[:, None]], dim=-1)
    xs_aug = rollout(functools.partial(problem_dynamics, prob_al), x0_aug,
                     us0)
    As, Bs = problem_linearize(prob_al, xs_aug[:, :-1], us0)
    _q, qx, ru, Qxx, Pux, Ruu = problem_quadratize_running(
        prob_al, xs_aug[:, :-1], us0)
    _qN, qxN, QN = problem_quadratize_final(prob_al, xs_aug[:, -1])
    m32 = tuple(x.contiguous() for x in (As, Bs, qx, ru, Qxx, Pux, Ruu, qxN,
                                         QN))
    rows = batch_first_rows(m32, n_aug, M, B, T, F32_REL_BOUND)
    for row in rows.values():
        assert row["copy_path"] == "per_element", row["copy_path"]
    lam_max = float(res.lam.max())
    assert lam_max > 0.0, "the velocity cap was never active"
    emit(phase="al", B=B, T=T, dtype="float32", n_augmented=n_aug,
         u_box=AL["u_max"], v_cap=AL["v_max"],
         max_violation=viol, constraint_tol=alc.constraint_tol,
         lam_max=lam_max, u_abs_max=float(u.abs().max()),
         outer_iterations_max=int(res.outer_iterations.max()),
         inner_iterations_mean=float(res.inner_iterations.float().mean()),
         lanes_by_status=by_status, solve_s=solve_s,
         batch_first_launches={name: launches, name64: launches64},
         f64=dict(B=Bf, T=Tf, rtol=AL_F64["rtol"], rel_diff=f64,
                  cpu_solve_s=cpu_s),
         kernel_rows=rows)
    return {name: launches, name64: launches64}, rows


def batch_first_rows(m32, n, m, B, T, f32_bound):
    """The batch-first entry at ``(n, m)`` on the batch-first local models
    ``m32`` (float32), in both types: equal (``torch.equal``) to the
    batch-last entry on the transposed inputs (the same arithmetic a lane in
    both layouts), within ``f32_bound`` (float32) or 1e-10 (float64) of the
    plain version relative to each output's largest magnitude, contiguous
    outputs, and no device memory asked for beyond them; then the entry's
    device time beside the batch-last kernel's, the plain version's time
    and the bound.  The entry copies no layout (the kernels read ``[B, T,
    ...]`` in place), so there is no copy to time.  Rows for the
    ``kernels`` line."""

    from ilqr_tpu_torch.ops.cuda_riccati import (from_batch_last,
                                                 kernel_name,
                                                 riccati_scan_cuda_batched,
                                                 riccati_scan_cuda_bl,
                                                 riccati_scan_plain_batched,
                                                 to_batch_last)

    rows = {}
    device = m32[0].device
    for dtype in (torch.float32, torch.float64):
        bf = tuple(x.to(dtype) for x in m32)
        reg = torch.logspace(-3, 0, B, dtype=dtype, device=device)
        got = riccati_scan_cuda_batched(*bf, reg)
        path = last_copy_path()
        bl = to_batch_last(bf)
        same = from_batch_last(riccati_scan_cuda_bl(*bl, reg))
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        plain = riccati_scan_plain_batched(*bf, reg)
        b.record()
        torch.cuda.synchronize()
        plain_ms = a.elapsed_time(b)
        bound = 1e-10 if dtype == torch.float64 else f32_bound
        # One more call: the device memory it asks for beyond what was
        # allocated before, against its outputs.  Bytes as requested: the
        # allocator may hand out a cached block somewhat larger.
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        key = "requested_bytes.all"
        before = torch.cuda.memory_stats()[f"{key}.current"]
        outs = riccati_scan_cuda_batched(*bf, reg)
        torch.cuda.synchronize()
        extra = torch.cuda.memory_stats()[f"{key}.peak"] - before
        out_bytes = sum(x.numel() * x.element_size() for x in outs)
        assert extra <= out_bytes, ((n, m), str(dtype), extra, out_bytes)
        del outs
        max_abs, max_rel = 0.0, 0.0
        for name, g, e, p in zip(("duffs", "Ks", "dv1", "dv2"), got, same,
                                 plain):
            assert g.shape == p.shape and g.dtype == p.dtype, name
            assert g.shape[0] == B, (name, g.shape)
            assert g.is_contiguous(), name
            assert torch.equal(g, e), f"{name}: batch-first != batch-last"
            assert bool(torch.isfinite(g).all()), f"{name}: not finite"
            r = rel_err(g, p)
            assert r <= bound, ((n, m), str(dtype), name, r, bound)
            max_abs = max(max_abs, float((g - p).abs().max()))
            max_rel = max(max_rel, r)
        bound_ms, bound_by = riccati_bound_ms(T, B, dtype, n, m)
        rows[kernel_name(n, m, dtype)] = dict(
            n=n, m=m, B=B, T=T, max_abs_err=max_abs, max_rel_err=max_rel,
            rel_bound=bound, equal_to_batch_last=True, copy_path=path,
            allocated_bytes=extra, output_bytes=out_bytes,
            ms=device_time(lambda: riccati_scan_cuda_batched(*bf, reg), 30),
            call_ms=sync_time(lambda: riccati_scan_cuda_batched(*bf, reg),
                              30),
            batch_last_ms=device_time(
                lambda: riccati_scan_cuda_bl(*bl, reg), 30),
            layout_copies="none",
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None)
        del got, same, plain, bl, bf
    return rows


def phase_trace_profile(problem, device):
    """``solve_with_trace`` of one float64 scenario (its last valid row is
    the result's iteration); one fused pass of phase ``solve``'s batch under
    ``device_trace`` (the trace file exists and names the Riccati kernel);
    ``PhaseTimer`` around the phases of one pass."""

    import json as _json

    from ilqr_tpu_torch import batched
    from ilqr_tpu_torch.config import ILQRConfig
    from ilqr_tpu_torch.problem import problem_dynamics, rollout
    from ilqr_tpu_torch.solver import solve
    from ilqr_tpu_torch.step import initial_state
    from ilqr_tpu_torch.utils.metrics import solve_with_trace
    from ilqr_tpu_torch.utils.profiling import (PhaseTimer, annotate,
                                                device_trace)

    T = TRACE["T"]
    cfg = ILQRConfig(max_iter=TRACE["max_iter"], tol=1e-6, tol_grad=1e-10,
                     tol_grad_rel=1e-6)
    x0 = torch.tensor([0.1, -0.1, 0.0, 0.0], dtype=torch.float64,
                      device=device)
    us0 = torch.zeros((T, M), dtype=torch.float64, device=device)
    xs0 = rollout(lambda x, u: problem_dynamics(problem, x, u), x0, us0)
    t0 = time.perf_counter()
    res, trace = solve_with_trace(problem, xs0, us0, config=cfg,
                                  device=device)
    trace_s = time.perf_counter() - t0
    plain = solve(problem, xs0, us0, config=cfg, device=device)
    for f in plain._fields:
        assert torch.equal(getattr(res, f), getattr(plain, f)), f
    valid = trace.valid.cpu()
    last = int(valid.sum()) - 1
    assert last + 1 == int(res.iterations) >= 1
    assert int(trace.status[last]) == int(res.status)
    assert float(trace.du_sq[last]) == float(res.du_sq)
    assert float(trace.alpha[last]) == float(res.alpha)

    B, T2 = HEADLINE["B"], HEADLINE["T"]
    x0s, us_b = scenario_inputs(B, T2, torch.float32, 0, device)
    us = us_b.movedim(0, -1).contiguous()
    xs = batched.rollout_bl(problem, x0s.T.contiguous(), us)
    pcfg = ILQRConfig(backward_backend="pallas", reg=1e-2)
    state = initial_state(xs, us, pcfg, lane_shape=(B,))
    timer = PhaseTimer()

    def one_pass():
        with annotate("derivatives"), timer.phase("derivatives"):
            models = batched.derivatives_bl(problem, xs, us)
        with annotate("riccati"), timer.phase("riccati"):
            gains = batched.riccati_bl(*models, reg=state.reg, config=pcfg)
        with annotate("forward_pass"), timer.phase("forward_pass"):
            batched.forward_pass_bl(problem, xs, us, *gains[:2],
                                    state.prev_cost, None, pcfg,
                                    dV1=gains[2], dV2=gains[3])

    one_pass()   # warm
    log_dir = scratch_path("trace")
    t0 = time.perf_counter()
    with device_trace(str(log_dir)):
        one_pass()
    traced_s = time.perf_counter() - t0
    trace_file = log_dir / "trace.json"
    assert trace_file.exists()
    events = _json.loads(trace_file.read_text())["traceEvents"]
    kernels = sorted({e["name"] for e in events
                      if "riccati_kernel" in e.get("name", "")})
    assert kernels, "the Riccati kernel is not in the trace"
    names = {e.get("name") for e in events}
    assert {"derivatives", "riccati", "forward_pass"} <= names
    emit(phase="trace_profile", trace_T=T, trace_dtype="float64",
         trace_rows_valid=last + 1, trace_status=trace.status.tolist(),
         solve_with_trace_s=trace_s, traced_pass_s=traced_s,
         trace_file_bytes=trace_file.stat().st_size,
         trace_events=len(events), riccati_kernels_in_trace=kernels,
         phase_timer=timer.summary().splitlines())


# ---------------------------------------------------------------------------
# The kernel at any (n, m); al_solve on the RBD arm; multi-device.
# ---------------------------------------------------------------------------

# Shapes no fixed instantiation has, built at first use: the RBD 2-DoF arm
# with al_solve's index coordinate (n=17, padded to (24, 8) in
# riccati_wide.cu, launched by phase al_rbd), and check-only shapes that no
# path of the system launches, one for each family route() serves: an odd
# shape padded to (8, 4), more controls than states padded to (8, 12) (the
# largest M served, past N), and riccati.cu's generic launcher at (3, 1) and
# at (5, 5), its largest shape.  Past the padded (24, 12), riccati_large.cu:
# the 6-DoF arm with the index coordinate (25, 12), launched by phase
# al_6dof, the plan's ceiling (32, 16), an odd shape, (29, 5), and more
# controls than states, (10, 13).
# Past (32, 16), riccati_xl.cu: the free-flying dual arm (36, 18), launched
# by phase rbd_dual, and the plan's ceiling (64, 32), both types; float32
# only, the dual arm with the index coordinate (37, 18), the first shape
# past (32, 16), (33, 16), and more controls than states at the ceiling's
# m, (20, 32).
# Past (64, 32), riccati_cluster.cu (a cluster of blocks a lane): the
# free-flying five-arm (72, 36), launched by phase rbd_five, and the plan's
# ceiling (128, 64), both types; float32 only, a 26-joint humanoid under
# al_solve (65, 32), the five-arm under al_solve (73, 36), m past 32 with a
# small n (20, 40), and (96, 48).
NEW_SHAPES = ((17, 8), (7, 3), (6, 11), (3, 1), (5, 5), (25, 12), (32, 16),
              (29, 5), (10, 13), (36, 18), (64, 32), (37, 18), (33, 16),
              (20, 32), (72, 36), (128, 64), (65, 32), (73, 36), (20, 40),
              (96, 48))
F32_ONLY_SHAPES = ((37, 18), (33, 16), (20, 32), (65, 32), (73, 36),
                   (20, 40), (96, 48))
CHECK_ONLY_SHAPES = ((7, 3), (6, 11), (3, 1), (5, 5), (32, 16), (29, 5),
                     (10, 13), (64, 32), (37, 18), (33, 16), (20, 32),
                     (128, 64), (65, 32), (73, 36), (20, 40), (96, 48))
# The rows at m >= 32 run at T_m32: at (64, 32) the plain version took about
# 22 s a call at T=100 on an H100 (the cut is printed).  The float64 rows'
# second check, symmetrize off, runs the last T_sym_off steps of the
# horizon: at full depth its plain version took 22 s of the phase on an
# H100 (the cut is printed).
SHAPES = dict(B=256, T=100, T_m32=25, T_sym_off=10)


def shape_T(m):
    """The horizon phase ``shapes`` runs a shape with ``m`` controls at."""

    return SHAPES["T_m32"] if m >= 32 else SHAPES["T"]
# The fixed instantiations whose outputs are hashed, on seeded inputs of
# this size: the same hashes on the tree before the kernel learned to pad
# show that their bits did not move.  With them, riccati_large.cu's al_6dof
# shape and its ceiling (kernel_name's instantiations), unchanged since
# that source's redesign.
HASH_SHAPES = ((4, 2), (5, 2), (16, 8), (24, 12))
LARGE_HASH_SHAPES = ((25, 12), (32, 16))
HASH = dict(B=64, T=50, seed=123)
# al_solve of an arm with a joint-velocity cap, float32, through the
# per-scenario engine: inner solves of 1 pass (cut from AL_ARM_INNER_UNCUT,
# to 3 with rbd_dual and to 1 with the phases of bench.py's strict, rbd
# --ls-*, mpc_batch --problem rbd and the DDP A/B, so that the script fits
# its time; the cut is printed) with a 4-rung
# ladder and Tassa regularization (rbd_config), max_outer cut so that the
# kernel run and its scan twin fit AL_ARM_BUDGET_S (cut from 60 s to 20 s
# with the inner passes, so that it still affords one outer iteration).
# Phase al_rbd runs it on the RBD 2-DoF arm (the kernel at (17, 8)), phase
# al_6dof on the 6-DoF arm (scripts/bench_6dof.py's B and T; the kernel at
# (25, 12)); on an H100 one outer iteration takes a third to half of the
# budget (the phases print it), so max_outer is cut to 1.
AL_ARM = dict(B=64, T=50, v_max=2.0, max_iter=1, max_backtracks=4,
              max_outer=10)
AL_ARM_INNER_UNCUT = 5
AL_ARM_BUDGET_S = 20.0
# The examples on the card, each at a small --steps (the defaults, 900 and
# 1000 steps with 40 and 50 iterations, are minutes of host-bound work);
# the RBD arm's --steps cut from 50 to 25 and --max-iter from 5 to 3 (18
# s on an H100) with the phases of bench.py's strict, rbd --ls-*,
# mpc_batch --problem rbd and the DDP A/B, so that the script fits its
# time.
EXAMPLES = (("torch_two_link_open_loop", ["--steps", "100"]),
            ("torch_two_link_swingup", ["--steps", "100", "--max-iter", "10"]),
            ("torch_rbd_arm", ["--steps", "25", "--max-iter", "3"]))
# The 2-link at the main path's width through sharded_batch_solve on a
# world-size-1 NCCL group.
SHARDED = dict(B=4096, T=100)
PIPELINE_NOTE = ("not run on the card: one H100, and the two-stage pipeline "
                 "needs two ranks; tests/test_torch_pipeline.py holds it "
                 "against the fused solve on two Gloo ranks on the CPU")


def synthetic_models(n, m, B, T, seed, device, dtype=torch.float64):
    """Batch-last local models ``(As, Bs, qx, ru, Qxx, Pux, Ruu, qxN, QN)``
    of a stable, well-conditioned problem, drawn in float64 on ``device``
    from ``seed`` (the same numbers on any tree), then cast.  Drawn on the
    card, not on the host: at ``(128, 64)``, B=256, T=25 the host took
    about 14 s to draw them.

    The stage cost ``[[Qxx, Pux'], [Pux, Ruu]]`` must stay positive
    semidefinite, or the recursion's ``H`` loses its Cholesky factor in the
    plain version as in the kernel: ``Qxx >= 0.1 I``, ``Ruu >= I``, and the
    cross term ``c * randn`` has a norm of about ``c (sqrt(n) + sqrt(m))``,
    which must stay under ``sqrt(0.1)``.  ``c = 0.05`` does up to ``(32,
    16)``; past it ``c = 0.2 / (sqrt(n) + sqrt(m))`` (at ``(64, 32)``, c =
    0.05 made 29 of 256 lanes NaN by T=100 in both versions)."""

    gen = torch.Generator(device=device).manual_seed(seed)
    f64 = dict(dtype=torch.float64, device=device)
    cross = (0.05 if n <= 32 and m <= 16
             else 0.2 / (n ** 0.5 + m ** 0.5))

    def randn(*shape):
        return torch.randn(shape, generator=gen, **f64)

    def spd(k, scale, steps=T):
        X = randn(steps, k, k, B) / k ** 0.5
        return (torch.einsum("tikb,tjkb->tijb", X, X) * scale
                + torch.eye(k, **f64)[None, :, :, None])

    models = (0.9 * torch.eye(n, **f64)[None, :, :, None]
              + 0.1 * randn(T, n, n, B) / n ** 0.5,
              0.3 * randn(T, n, m, B), 0.1 * randn(T, n, B),
              0.1 * randn(T, m, B), 0.1 * spd(n, 0.5),
              cross * randn(T, m, n, B), spd(m, 0.2), randn(n, B),
              spd(n, 1.0, 1)[0])
    return tuple(x.to(dtype).contiguous() for x in models)


def shape_types(n, m):
    """The types phase ``shapes`` runs ``(n, m)`` in."""

    return ((torch.float32,) if (n, m) in F32_ONLY_SHAPES
            else (torch.float32, torch.float64))


def instantiation_hashes(device):
    """sha256 of the outputs of each fixed instantiation and of the
    ``riccati_large.cu`` instantiations of LARGE_HASH_SHAPES (batch-last and
    batch-first entries, both types) on seeded inputs.  Uses only what every
    tree of the port with ``riccati_large.cu`` has, so that the same function
    can hash an older tree's kernels."""

    import hashlib

    from ilqr_tpu_torch.ops import cuda_riccati

    out = {}
    for n, m in HASH_SHAPES + LARGE_HASH_SHAPES:
        for dtype in (torch.float32, torch.float64):
            models = synthetic_models(n, m, HASH["B"], HASH["T"],
                                      HASH["seed"] + n, device, dtype)
            reg = torch.logspace(-3, 0, HASH["B"], dtype=dtype, device=device)
            bf = tuple(x.movedim(-1, 0).contiguous() for x in models)
            for entry, outs in (
                    ("batch_last", cuda_riccati.riccati_scan_cuda_bl(
                        *models, reg)),
                    ("batch_first", cuda_riccati.riccati_scan_cuda_batched(
                        *bf, reg))):
                h = hashlib.sha256()
                for x in outs:
                    h.update(x.contiguous().cpu().numpy().tobytes())
                out[f"{cuda_riccati.kernel_name(n, m, dtype)}:{entry}"] = (
                    h.hexdigest())
    return out


def cluster_info(_build, library, source):
    """``{"blocks_a_lane": C, "clusters_resident": {"batch_last": k,
    "batch_first": k}}`` of a ``riccati_cluster.cu`` instantiation: the
    blocks of a lane's cluster and the clusters resident on this card at
    once, as ``cudaOccupancyMaxActiveClusters`` counts them (None for the
    other sources)."""

    if source != "riccati_cluster":
        return None
    lib = _build.load(library)
    fn = lib.riccati_cuda_instance_clusters_resident
    return {"blocks_a_lane": lib.riccati_cuda_instance_cluster_size(),
            "clusters_resident": {"batch_last": fn(0), "batch_first": fn(1)}}


def resident_blocks(_build, library, source):
    """``{"batch_last": k, "batch_first": k}``: the blocks (lanes) of a
    ``riccati_large.cu`` or ``riccati_xl.cu`` instantiation resident on one
    SM of this card, as ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``
    counts them (None for the other sources)."""

    if source not in ONE_LANE_A_BLOCK:
        return None
    fn = _build.load(library).riccati_cuda_instance_blocks_per_sm
    return {"batch_last": fn(0), "batch_first": fn(1)}


# The instantiations of riccati_large.cu that --large-times times, on the
# seeded inputs of phase shapes: its four shapes at B=256, T=100 and al_6dof's
# (25, 12) at its B=64, T=50.  Their float64 stage clocks come with them at
# B=256 (phase shapes has the float32 ones).
LARGE_TIMES = (((25, 12), 256, 100), ((32, 16), 256, 100), ((29, 5), 256, 100),
               ((10, 13), 256, 100), ((25, 12), 64, 50))


def large_times(device):
    """Device time (ms) of both entries of every ``riccati_large.cu``
    instantiation of LARGE_TIMES, both types, and the cycles a step by stage
    of the float64 ones at B=256 (batch-last), with the seconds those stage
    clocks took (their ``nvcc`` runs and launches).  Uses only what every
    tree of the port since that source came has, so that the same function
    times an older tree's plan: ``python3 chip_smoke.py --large-times
    ROOT``."""

    from ilqr_tpu_torch.ops import _build, cuda_riccati

    types = (torch.float32, torch.float64)
    _build.build(sorted({cuda_riccati.library_and_symbol(n, m, dtype)[0]
                         for (n, m), _, _ in LARGE_TIMES for dtype in types}))
    out = {}
    for (n, m), B, T in LARGE_TIMES:
        for dtype in types:
            bl = synthetic_models(n, m, B, T, 7 * n + m, device, dtype)
            bf = tuple(x.movedim(-1, 0).contiguous() for x in bl)
            reg = torch.logspace(-3, 0, B, dtype=dtype, device=device)
            name = cuda_riccati.kernel_name(n, m, dtype)
            out[f"{name}:B{B}_T{T}"] = dict(
                batch_last=device_time(
                    lambda: cuda_riccati.riccati_scan_cuda_bl(*bl, reg), 20),
                batch_first=device_time(
                    lambda: cuda_riccati.riccati_scan_cuda_batched(*bf, reg),
                    20))
            del bl, bf
    t0 = time.perf_counter()
    clocked = [((n, m), B, T) for (n, m), B, T in LARGE_TIMES if B == 256]
    _build.build([f"{cuda_riccati.library_and_symbol(n, m, torch.float64)[0]}"
                  "_clocks" for (n, m), _, _ in clocked])
    stage = {}
    for (n, m), B, T in clocked:
        bl = synthetic_models(n, m, B, T, 7 * n + m, device, torch.float64)
        reg = torch.logspace(-3, 0, B, dtype=torch.float64, device=device)
        stage[cuda_riccati.kernel_name(n, m, torch.float64)] = (
            cuda_riccati.riccati_stage_clocks(bl, reg))
        del bl
    return dict(times=out, f64_stage_cycles=stage,
                f64_stage_clock_s=time.perf_counter() - t0)


# The instantiations of riccati_xl.cu that --xl-times times: those of
# NEW_SHAPES that route there, at phase shapes' B, T and types and on its
# seeded inputs, and rbd_dual's launch, (36, 18) float32 at DUAL's B=64,
# T=50.
XL_TIMES = tuple(
    ((n, m), SHAPES["B"], shape_T(m), shape_types(n, m))
    for n, m in NEW_SHAPES
    if (n > 32 or m > 16) and n <= 64 and m <= 32) + (
    ((36, 18), DUAL["B"], DUAL["T"], (torch.float32,)),)


def source_times(device, rows, source):
    """Device time (ms) of both entries of every row ``((n, m), B, T,
    types)`` of ``rows`` (XL_TIMES, CLUSTER_TIMES), all of one ``source``,
    with the copy path each entry took and a sha256 of each entry's outputs,
    the shared bytes the source reckons, the blocks an SM
    (``riccati_xl.cu``) or the blocks a lane and the clusters resident
    (``riccati_cluster.cu``), ``ptxas``' registers and spills, and the
    cycles a step by stage of each entry where the tree's
    ``cuda_riccati.STAGES`` names the source (a stage-clock build); then the
    seconds it all took.  A row's timing takes 20 calls, fewer where one
    call passes 10 ms (about 200 ms of launches; at least 3).  Uses only
    what every tree of the port since the source came has, so that the same
    function times an older tree's plan: ``python3 chip_smoke.py
    --xl-times ROOT`` or ``--cluster-times ROOT``."""

    import hashlib

    from ilqr_tpu_torch.ops import _build, cuda_riccati

    t0 = time.perf_counter()
    clocked = source in cuda_riccati.STAGES
    libraries = sorted({cuda_riccati.library_and_symbol(n, m, dtype)[0]
                        for (n, m), _, _, types in rows for dtype in types})
    _build.build(libraries + ([f"{name}_clocks" for name in libraries]
                              if clocked else []))
    build_s = time.perf_counter() - t0
    out = {}
    for (n, m), B, T, types in rows:
        # Drawn once a shape in float64, as phase shapes draws them.
        f64 = synthetic_models(n, m, B, T, 7 * n + m, device)
        for dtype in types:
            bl = tuple(x.to(dtype).contiguous() for x in f64)
            bf = tuple(x.movedim(-1, 0).contiguous() for x in bl)
            reg = torch.logspace(-3, 0, B, dtype=dtype, device=device)
            name = cuda_riccati.kernel_name(n, m, dtype)
            library = cuda_riccati.library_and_symbol(n, m, dtype)[0]
            row = dict(
                shared_bytes=(_build.load(library)
                              .riccati_cuda_instance_shared_bytes()),
                resident_blocks_per_sm=resident_blocks(_build, library, source),
                cluster=cluster_info(_build, library, source),
                ptxas=ptxas_summary(_build, [library]))
            for entry, fn, arrays, layout in (
                    ("batch_last", cuda_riccati.riccati_scan_cuda_bl, bl,
                     cuda_riccati.BATCH_LAST),
                    ("batch_first", cuda_riccati.riccati_scan_cuda_batched,
                     bf, cuda_riccati.BATCH_FIRST)):
                outs = fn(*arrays, reg)
                h = hashlib.sha256()
                for x in outs:
                    h.update(x.contiguous().cpu().numpy().tobytes())
                path = last_copy_path()
                reps = max(3, min(20, int(200.0 / max(
                    device_time(lambda: fn(*arrays, reg), 1), 1e-3))))
                row[entry] = dict(
                    ms=device_time(lambda: fn(*arrays, reg), reps),
                    timing_reps=reps, copy_path=path, sha256=h.hexdigest())
                if clocked:
                    row[entry]["stage_cycles"] = (
                        cuda_riccati.riccati_stage_clocks(arrays, reg,
                                                          layout))
            out[f"{name}:B{B}_T{T}"] = row
            del bl, bf
        del f64
    return dict(rows=out, build_s=build_s,
                seconds=time.perf_counter() - t0)


# The instantiations of riccati_cluster.cu that --cluster-times times: those
# of NEW_SHAPES that route there, at phase shapes' B and T and on its seeded
# inputs, in both types (shapes runs some in float32 only: these are where
# the float64 ones are run on the card and their bits compared with another
# tree's), and rbd_five's launch, (72, 36) float32 at DUAL's B=64, T=50.
CLUSTER_TIMES = tuple(
    ((n, m), SHAPES["B"], shape_T(m), (torch.float32, torch.float64))
    for n, m in NEW_SHAPES if n > 64 or m > 32) + (
    ((72, 36), DUAL["B"], DUAL["T"], (torch.float32,)),)


def phase_shapes(device, built):
    """The kernel at the shapes of NEW_SHAPES, built at first use: both
    entries, both types, on seeded inputs at B=256, T=100, against the plain
    version at the existing bars (``symmetrize`` off too, in float64, on
    the last ``SHAPES["T_sym_off"]`` steps), the
    two entries equal (``torch.equal``); the time beside the bound (logical
    bytes read and written once over 3.35 TB/s) and the plain version's, the
    padded plan and its bytes, registers and spills, the blocks resident
    on an SM (``riccati_large.cu``, ``riccati_xl.cu``), the copy path, the
    ``nvcc`` seconds of the new libraries (``built``), the cycles a step by
    stage of those two sources' float32 rows.  F32_ONLY_SHAPES run in
    float32 only.  Then the hashes of the fixed instantiations' outputs and
    of two ``riccati_large.cu`` ones.  Returns ``(batch-last rows,
    batch-first rows)`` for the ``kernels`` line."""

    from ilqr_tpu_torch.ops import _build, cuda_riccati
    from ilqr_tpu_torch.ops.cuda_riccati import (from_batch_last,
                                                 riccati_scan_cuda_batched,
                                                 riccati_scan_cuda_bl,
                                                 riccati_scan_plain_bl)

    B = SHAPES["B"]
    rows_bl, rows_bf = {}, {}
    print(f"chip_smoke: shapes: T cut from {SHAPES['T']} to "
          f"{SHAPES['T_m32']} at m >= 32, and to {SHAPES['T_sym_off']} for "
          f"the float64 check with symmetrize off (the plain version's "
          f"time)", file=sys.stderr, flush=True)
    for n, m in NEW_SHAPES:
        T = shape_T(m)
        # Drawn once a shape in float64 (the float32 row is its cast: the
        # same values synthetic_models(..., dtype) gives).
        f64 = synthetic_models(n, m, B, T, 7 * n + m, device)
        for dtype in shape_types(n, m):
            bl = tuple(x.to(dtype).contiguous() for x in f64)
            bf = tuple(x.movedim(-1, 0).contiguous() for x in bl)
            reg = torch.logspace(-3, 0, B, dtype=dtype, device=device)
            name = cuda_riccati.kernel_name(n, m, dtype)
            source, NP, MP = cuda_riccati.route(n, m)
            got = riccati_scan_cuda_bl(*bl, reg)
            path_bl = last_copy_path()
            got_bf = riccati_scan_cuda_batched(*bf, reg)
            path_bf = last_copy_path()
            torch.cuda.synchronize()
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            plain = riccati_scan_plain_bl(*bl, reg)
            b.record()
            torch.cuda.synchronize()
            plain_ms = a.elapsed_time(b)
            max_abs, max_rel = hold(got, plain, F32_REL_BOUND)
            for g, e in zip(got_bf, from_batch_last(got)):
                assert torch.equal(g, e), (name, "batch-first != batch-last")
            if dtype == torch.float64:
                tail = (tuple(x[-SHAPES["T_sym_off"]:] for x in bl[:7])
                        + bl[7:])
                hold(riccati_scan_cuda_bl(*tail, reg, symmetrize=False),
                     riccati_scan_plain_bl(*tail, reg, symmetrize=False),
                     F32_REL_BOUND)
            bound_ms, bound_by = riccati_bound_ms(T, B, dtype, n, m)
            library = cuda_riccati.library_and_symbol(n, m, dtype)[0]
            # The plan's shared memory, as the source reckons it.
            plan_bytes = (
                _build.load(library).riccati_cuda_instance_shared_bytes()
                if source != "riccati" else None)
            common = dict(
                n=n, m=m, B=B, T=T, source=source, padded=[NP, MP],
                plan_bytes=plan_bytes,
                resident_blocks_per_sm=resident_blocks(_build, library,
                                                       source),
                cluster=cluster_info(_build, library, source),
                ptxas=ptxas_summary(_build, [library]),
                library=library,
                nvcc_s=built.get(library), max_abs_err=max_abs,
                max_rel_err=max_rel,
                rel_bound=1e-10 if dtype == torch.float64 else F32_REL_BOUND,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None,
                check_only=(n, m) in CHECK_ONLY_SHAPES)
            # 20 calls a timing, fewer where one call passes 10 ms (about
            # 200 ms of launches a timing; at least 3).
            reps = max(3, min(20, int(200.0 / max(
                device_time(lambda: riccati_scan_cuda_bl(*bl, reg), 1),
                1e-3))))
            if reps < 20:
                print(f"chip_smoke: shapes: {name}: timing calls cut from 20 "
                      f"to {reps} (about 200 ms of launches)",
                      file=sys.stderr, flush=True)
            rows_bl[name] = dict(
                common, copy_path=path_bl, timing_reps=reps,
                ms=device_time(lambda: riccati_scan_cuda_bl(*bl, reg), reps),
                call_ms=sync_time(lambda: riccati_scan_cuda_bl(*bl, reg),
                                  reps))
            if source in ONE_LANE_A_BLOCK and dtype == torch.float32:
                # Cycles a step by stage, from the stage-clock build.
                rows_bl[name]["stage_cycles"] = (
                    cuda_riccati.riccati_stage_clocks(bl, reg))
            rows_bf[name] = dict(
                common, copy_path=path_bf, equal_to_batch_last=True,
                timing_reps=reps,
                ms=device_time(lambda: riccati_scan_cuda_batched(*bf, reg),
                               reps),
                batch_last_ms=rows_bl[name]["ms"])
            del bl, bf, got, got_bf, plain
        del f64
    emit(phase="shapes", rows_batch_last=rows_bl, rows_batch_first=rows_bf,
         f64_rtol=1e-10, f32_rel_bound=F32_REL_BOUND,
         hashes_of_fixed_instantiations=instantiation_hashes(device),
         hash_inputs=HASH)
    return rows_bl, rows_bf


def phase_al_rbd(cases, device):
    """``al_solve`` of the RBD 2-DoF arm with a joint-velocity cap, B=64,
    T=50: the index coordinate makes the state n=17, so every inner backward
    pass launches the batch-first entry of the ``(17, 8)`` instantiation
    (padded to (24, 8) in ``riccati_wide.cu``).  See :func:`al_arm`."""

    return al_arm("al_rbd", cases[False], AL_ARM, AL_ARM_BUDGET_S, device)


def phase_al_6dof(cases, device):
    """``al_solve`` of the 6-DoF arm with its six joint velocities capped,
    B=64, T=50: the state is n=25 with the index, so every inner backward
    pass launches the batch-first entry of the ``(25, 12)`` instantiation,
    past the padded (24, 12), in ``riccati_large.cu``.  See
    :func:`al_arm`."""

    return al_arm("al_6dof", cases[True], AL_ARM, AL_ARM_BUDGET_S, device)


def al_arm(phase, case, spec, budget_s, device):
    """``al_solve`` of a floating-base arm with ``|joint velocity| <=
    spec["v_max"]``, float32, ``backward_backend="pallas"``: every inner
    backward pass launches the batch-first entry of the kernel at the
    augmented ``(n + 1, m)``.  ``max_outer`` cut to ``budget_s`` (printed);
    where one outer iteration leaves room for no second, the run that timed
    it is the phase's run.  Held against the same call with ``"scan"``:
    ``status`` equal, and ``us`` as the RBD solves are held after a cut solve
    (the median lane within F32_SOLVE_MEDIAN_BOUND_RBD of max|us|, the cost
    of every lane within F32_SOLVE_COST_BOUND_RBD; the worst lane printed).
    Then the kernel at this phase's shapes against its plain version, on
    what its first launch was handed (as phase ``al`` holds ``(5, 2)``)."""

    import functools

    from ilqr_tpu_torch import al
    from ilqr_tpu_torch.derivatives import (problem_linearize,
                                            problem_quadratize_final,
                                            problem_quadratize_running)
    from ilqr_tpu_torch.ops import cuda_riccati
    from ilqr_tpu_torch.problem import problem_dynamics, rollout

    problem = case[0]
    B, T = spec["B"], spec["T"]
    x0s, us0 = rbd_inputs(case, B, T, torch.float32, 31, device)
    v_max = spec["v_max"]
    # The joints: what the floating base's six velocities leave of nv.
    joints = problem.control_dim - 6

    def cap(x, u):
        # |joint velocity| <= v_max: the last `joints` state components
        # (the state's components lead, batch axes trail).
        v = torch.as_tensor(v_max, dtype=x.dtype, device=x.device)
        return torch.cat([x[-joints:] - v, -x[-joints:] - v])

    def run(backend, max_outer):
        cfg = rbd_config(spec["max_iter"], T, backend).replace(
            max_backtracks=spec["max_backtracks"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = al.al_solve(problem, x0s, us0, cap, config=cfg,
                          al_config=al.ALConfig(max_outer=max_outer),
                          device=device)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    name = cuda_riccati.kernel_name(problem.state_dim + 1,
                                    problem.control_dim, torch.float32)
    if spec["max_iter"] < AL_ARM_INNER_UNCUT:
        print(f"chip_smoke: {phase}: inner max_iter cut from "
              f"{AL_ARM_INNER_UNCUT} to {spec['max_iter']} so that the script "
              f"fits its time", file=sys.stderr, flush=True)
    # One outer iteration sets the cut; it is the run itself where the
    # budget allows no more.
    cuda_riccati.reset_launch_counts()
    res, one_s = run("pallas", 1)
    solve_s = one_s
    max_outer = max(1, min(spec["max_outer"], int(budget_s / (2 * one_s))))
    if max_outer < spec["max_outer"]:
        print(f"chip_smoke: {phase}: max_outer cut from {spec['max_outer']} "
              f"to {max_outer} by the {budget_s} s budget",
              file=sys.stderr, flush=True)
    if max_outer > 1:
        cuda_riccati.reset_launch_counts()
        res, solve_s = run("pallas", max_outer)
    launches = count_batch_first(name)
    assert launches >= int(res.outer_iterations.max()) >= 1, launches
    cuda_riccati.reset_launch_counts()
    ref, scan_s = run("scan", max_outer)
    assert cuda_riccati.launches() == 0
    for r in (res, ref):
        assert r.us.shape == (B, T, problem.control_dim)
        assert r.us.dtype == torch.float32
        assert bool(torch.isfinite(r.us).all())
    assert torch.equal(res.status, ref.status), (res.status, ref.status)
    scale = float(ref.us.abs().max())
    lane_rel = ((res.us - ref.us).abs().amax(dim=(1, 2)) / scale)
    cost_rel = ((res.cost - ref.cost).abs() / ref.cost.abs())
    median = float(lane_rel.median())
    assert median <= F32_SOLVE_MEDIAN_BOUND_RBD, median
    assert float(cost_rel.max()) <= F32_SOLVE_COST_BOUND_RBD, cost_rel.max()
    by_status = lanes_by_status(res.status)

    # The kernel on the local models of the first augmented problem
    # (multipliers 0, penalty mu0) at the rollout of zero controls: what its
    # first launch was handed.  A lane's batch-first step is not whole
    # 16-byte rows at n=17, so riccati_wide.cu copies per element;
    # riccati_large.cu copies each input's aligned superset in bulk (path
    # "tma": the bulk-copy engine) from the 16-byte aligned inputs.
    n_aug, m = problem.state_dim + 1, problem.control_dim
    p = 2 * joints
    lanes = torch.arange(B, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    prob_al = al._augment_problem(
        problem, cap, None, torch.zeros((B * T, p), **f32),
        torch.zeros((B, 1), **f32),
        torch.full((B,), al.ALConfig().mu0, **f32),
        torch.zeros(p, dtype=torch.bool, device=device),
        torch.zeros(1, dtype=torch.bool, device=device), T)
    x0_aug = torch.cat([x0s, (lanes * T).to(torch.float32)[:, None]], dim=-1)
    xs_aug = rollout(functools.partial(problem_dynamics, prob_al), x0_aug,
                     us0)
    As, Bs = problem_linearize(prob_al, xs_aug[:, :-1], us0)
    _q, qx, ru, Qxx, Pux, Ruu = problem_quadratize_running(
        prob_al, xs_aug[:, :-1], us0)
    _qN, qxN, QN = problem_quadratize_final(prob_al, xs_aug[:, -1])
    m32 = tuple(x.contiguous() for x in (As, Bs, qx, ru, Qxx, Pux, Ruu, qxN,
                                         QN))
    assert m32[0].shape == (B, T, n_aug, n_aug), m32[0].shape
    rows = batch_first_rows(m32, n_aug, m, B, T, F32_REL_BOUND)
    path = ("tma" if cuda_riccati.route(n_aug, m)[0] == "riccati_large"
            else "per_element")
    for row in rows.values():
        assert row["copy_path"] == path, (row["copy_path"], path)
    del m32, As, Bs, qx, ru, Qxx, Pux, Ruu, qxN, QN
    emit(phase=phase, B=B, T=T, dtype="float32",
         n_augmented=problem.state_dim + 1, m=problem.control_dim,
         v_cap=v_max, capped_joints=joints, inner_max_iter=spec["max_iter"],
         max_outer=max_outer, max_outer_config=spec["max_outer"],
         one_outer_iteration_is_the_run=max_outer == 1,
         budget_s=budget_s, one_outer_s=one_s, solve_s=solve_s,
         scan_solve_s=scan_s, batch_first_launches={name: launches},
         lanes_by_status=by_status,
         max_violation=float(res.max_violation.max()),
         lam_max=float(res.lam.max()),
         outer_iterations_max=int(res.outer_iterations.max()),
         inner_iterations_mean=float(res.inner_iterations.float().mean()),
         vs_scan=dict(status_equal=True, median_lane_rel=median,
                      worst_lane_rel=float(lane_rel.max()),
                      worst_cost_rel=float(cost_rel.max()),
                      median_bound=F32_SOLVE_MEDIAN_BOUND_RBD,
                      cost_bound=F32_SOLVE_COST_BOUND_RBD),
         kernel_rows=rows)
    return {name: launches}, rows


@contextlib.contextmanager
def nccl_world_of_one(device):
    """A world-size-1 NCCL process group (a ``TCPStore`` on 127.0.0.1, a
    free port), destroyed at the end."""

    import datetime

    import torch.distributed as dist

    from ilqr_tpu_torch.parallel.distributed import free_local_port
    from ilqr_tpu_torch.parallel.mesh import backend_for

    store = dist.TCPStore("127.0.0.1", free_local_port(), 1, True,
                          timeout=datetime.timedelta(seconds=60))
    backend = backend_for(device)
    assert backend == "nccl", backend
    dist.init_process_group(backend, store=store, rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def phase_sharded(problem, cfg, device):
    """``sharded_batch_solve`` on a world-size-1 NCCL group at the main
    path's width (2-link, B=4096, T=100, float32, the kernel, phase
    ``solve``'s config): ``torch.equal`` to ``make_batch_solver(engine=
    "vmap")`` on the same inputs in ``us``, ``status`` and ``iterations``;
    the reduced metrics equal to the sums of ``batch_metrics``
    (``n_converged`` and the iteration count exactly, ``mean_cost`` to
    rtol 1e-6: a sum over B divided by B against ``torch.mean``)."""

    import torch.distributed as dist

    from ilqr_tpu_torch.ops import cuda_riccati
    from ilqr_tpu_torch.parallel.batching import (batch_metrics,
                                                  make_batch_solver)
    from ilqr_tpu_torch.parallel.mesh import (make_scenario_mesh,
                                              shard_scenarios,
                                              sharded_batch_solve)

    B, T = SHARDED["B"], SHARDED["T"]
    x0s, us0 = scenario_inputs(B, T, torch.float32, 5, device)
    name = cuda_riccati.kernel_name(N, M, torch.float32)
    with nccl_world_of_one(device):
        mesh = make_scenario_mesh()
        assert mesh.size == 1 and mesh.device == device, mesh
        backend = dist.get_backend(mesh.group)
        # The group's first collective sets NCCL up: not in the timed solve.
        dist.all_reduce(torch.zeros(1, device=device), group=mesh.group)
        x_loc, u_loc = shard_scenarios(mesh, x0s, us0)
        cuda_riccati.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, metrics = sharded_batch_solve(problem, mesh, x_loc, u_loc,
                                           config=cfg)
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t0
        launches = count_batch_first(name)
        assert launches == int(res.iterations.max()) >= 1, launches
        metrics = {k: v.item() for k, v in metrics.items()}
    solve_fn = make_batch_solver(problem, cfg, engine="vmap", device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = solve_fn(x0s, us0)
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    for f in ("us", "status", "iterations"):
        assert torch.equal(getattr(res, f), getattr(ref, f)), f
    want = batch_metrics(ref)
    assert metrics["n_converged"] == int(want["n_converged"])
    assert metrics["total_iterations"] == int(ref.iterations.sum())
    assert abs(metrics["mean_cost"] - float(want["mean_cost"])) <= (
        1e-6 * abs(float(want["mean_cost"]))), (metrics, want)
    emit(phase="sharded", B=B, T=T, dtype="float32", world_size=1,
         backend=backend, axis=mesh.axis, solve_s=solve_s,
         solves_per_s=B / solve_s, vmap_solve_s=ref_s,
         vmap_solves_per_s=B / ref_s, metrics=metrics,
         equal_to_vmap_solve=True, batch_first_launches={name: launches})
    return {name: launches}


def phase_entry(device):
    """``entry()`` once on the card, then ``dryrun_multichip(1)``: one rank
    on a NCCL group, the JAX dry run's two checks."""

    from ilqr_tpu_torch import entry

    fn, args = entry.entry(device=device)
    t0 = time.perf_counter()
    xs, us, cost = fn(*args)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    assert xs.shape == (33, 4) and us.shape == (32, 2), (xs.shape, us.shape)
    assert bool(torch.isfinite(cost)) and xs.device == device
    t0 = time.perf_counter()
    summaries = entry.dryrun_multichip(1, device=device)
    dry_s = time.perf_counter() - t0
    assert [s["backend"] for s in summaries] == ["nccl"], summaries
    emit(phase="entry", entry_shapes=[list(xs.shape), list(us.shape)],
         entry_cost=float(cost), entry_step_s=step_s,
         dryrun_multichip_1=summaries, dryrun_s=dry_s)
    emit(phase="pipeline", run=False, reason=PIPELINE_NOTE)


def phase_examples(device):
    """The port's examples as a user runs them, on the card (no ``--cpu``),
    each ``main`` at the small ``--steps`` of EXAMPLES: what each prints,
    and its result finite, on the card, of the expected shape.  Where
    matplotlib is missing, the examples skip only the animation (they say
    so on stderr)."""

    import importlib.util
    import io
    from pathlib import Path

    root = Path(__file__).resolve().parent / "examples"
    runs = {}
    for name, argv in EXAMPLES:
        spec = importlib.util.spec_from_file_location(name,
                                                      root / f"{name}.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        if name != "torch_rbd_arm":
            # The 2-link examples write an animation by default: here, where
            # matplotlib allows one, into the scratch directory.
            argv = argv + ["--out", str(scratch_path(f"{name}.gif"))]
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            result = module.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        lines = out.getvalue().splitlines()
        steps = int(argv[argv.index("--steps") + 1])
        xs = result if name == "torch_two_link_open_loop" else result.xs
        assert xs.device.type == "cuda" and xs.shape[-2] == steps + 1, (
            name, xs.device, xs.shape)
        assert bool(torch.isfinite(xs).all()), name
        if name == "torch_two_link_open_loop":
            assert lines[0].startswith(f"rolled out {steps} steps"), lines
        else:
            iters = int(result.iterations)
            assert iters >= 1 and len([ln for ln in lines if ln.startswith(
                "Iteration: ")]) == iters, lines
            assert any(ln.startswith(f"status={int(result.status)} "
                                     f"iterations={iters}") for ln in lines)
        runs[name] = dict(argv=argv, seconds=seconds, printed=lines)
    emit(phase="examples", runs=runs)


# ---------------------------------------------------------------------------
# What bench.py and scripts/bench_ddp.py run that no phase above does:
# --config strict (exact_ls_delta), --config rbd with the warm-started
# expected-decrease ladder, --config mpc_batch --problem rbd, and full DDP
# against iLQR (ddp, reg_in_value).
# ---------------------------------------------------------------------------

# bench.py --config strict (bench.py:347-364): the reference's stopping rule
# sum((du)^2) <= 1e-6 with no gradient test, exact_ls_delta, at most 100
# passes, at the main path's width.  TPU: what its log printed.
STRICT = dict(B=4096, T=100, max_iter=100, tol=1e-6)
STRICT_TPU = dict(lanes_converged=4096, mean_iterations=7.7,
                  log="bench_logs/r5/headline_strict.log")
# bench.py --config rbd --ls-warm --ls-expected --ls-c 0.4 (the TPU's best
# RBD row, BENCH.md:565-566): phase rbd_solve's chunked solve (T cut to
# RBD["T_cut"]) with the warm-started expected-decrease ladder; max_iter
# cut so that the solve fits RBD_LS_BUDGET_S, from the time of two passes
# (on an H100 two passes took 13 s, so the cut leaves 2).
RBD_LS = dict(B=256, ls_c=0.4, iter_chunk=10)
RBD_LS_BUDGET_S = 15.0
# bench.py --config mpc_batch --problem rbd (bench.py:230-270, :435-441): a
# fleet of 64 floating-base arms replanning in lock-step, H=50, 50 steps of
# at most 10 passes, Tassa reg, the perturbation of the attitude (0.02) and
# the pose (0.05) about bench.py's nominal.  The replans' max_iter and then
# n_steps are cut from the time of one pass so that the scan and the kernel
# runs fit MPC_RBD_BUDGET_S together.
MPC_RBD = dict(B=64, H=50, n_steps=50, max_iter=10, attitude=0.02,
               pose=0.05)
MPC_RBD_BUDGET_S = 25.0
# scripts/bench_ddp.py: the 2-link, B=64, T=100, tol 1e-6, at most 200
# passes, exact_ls_delta, its rows in its order; x0 0.2 and us0 0.01 times
# numpy's default_rng(0) normals.  TPU: converged, mean and max iterations
# and mean cost as bench_logs/r5/ddp_two_link.log printed them, at T=100.
# T is cut to T_cut: at T=100 the four rows took 191 s on an H100's host
# (390 rollouts of the per-scenario ladder, each about 20,000 kernels
# issued from Python), and matched the TPU's rows.
DDP = dict(B=64, T=100, T_cut=50, max_iter=200, tol=1e-6)
DDP_ROWS = (("ilqr", {}), ("ddp", dict(ddp=True)),
            ("ddp+areg", dict(ddp=True, adaptive_reg=True,
                              reg_backtrack_trigger=4)),
            ("ilqr+areg", dict(adaptive_reg=True, reg_backtrack_trigger=4)))
DDP_TPU = {"log": "bench_logs/r5/ddp_two_link.log",
           "ilqr": [64, 5.8, 8, 267.699], "ddp": [48, 3.8, 6, 396.468],
           "ddp+areg": [64, 6.2, 12, 267.699],
           "ilqr+areg": [64, 5.7, 8, 267.699],
           "columns": ["converged", "mean_iterations", "max_iterations",
                       "mean_cost"]}


def timed_call(fn, *args):
    """``(fn(*args), seconds)`` on the host's clock, synchronized."""

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def lanes_by_status(status):
    from ilqr_tpu_torch.config import Status

    return {Status(int(c)).name: int((status == c).sum())
            for c in status.unique()}


def card_against_cpu(run, device, launches_of, *fields):
    """``run(dev)`` on the CPU (the plain version) and on ``device``, the
    card (the kernel where the config says so), float64: ``status`` and
    ``iterations`` (or ``statuses``) equal, each of ``fields`` to rtol 1e-8
    (atol 1e-10), as phase ``parity`` holds them.  ``launches_of()`` reads
    the card run's launches (counts set to 0 just before it).  Returns a
    summary."""

    from ilqr_tpu_torch.ops import cuda_riccati

    cpu = run("cpu")
    cuda_riccati.reset_launch_counts()
    gpu = run(device)
    launches = launches_of()
    out = {"launches": launches}
    for f in ("status", "statuses", "iterations"):
        if hasattr(cpu, f):
            a, b = getattr(cpu, f), getattr(gpu, f).cpu()
            assert torch.equal(a, b), (f, a, b)
            out[f] = a.tolist()
    for f in fields:
        a, b = getattr(cpu, f), getattr(gpu, f).cpu()
        assert a.dtype == b.dtype == torch.float64, (f, a.dtype, b.dtype)
        torch.testing.assert_close(b, a, rtol=1e-8, atol=1e-10,
                                   msg=lambda s: f"{f}: {s}")
        out[f"{f}_max_abs_diff"] = float((b - a).abs().max())
    return out


def phase_strict(problem, device):
    """``bench.py --config strict``: ``make_batch_solver(engine="fused")``
    with the kernel, float32, STRICT's config (``exact_ls_delta``: the
    line search's decrease as a sum of per-step differences, a candidate
    equal to the iterate accepted).  Launches equal passes; lanes by status
    and mean iterations beside the TPU's; the same inputs through
    ``"scan"``: status equal on every lane, ``us`` within
    F32_SOLVE_REL_BOUND of max|us| on the lanes at the same count (more
    than half of them); float64 at B=8, T=24, card against CPU."""

    from ilqr_tpu_torch.config import ILQRConfig
    from ilqr_tpu_torch.ops import cuda_riccati
    from ilqr_tpu_torch.parallel.batching import (batch_metrics,
                                                  make_batch_solver)

    B, T = STRICT["B"], STRICT["T"]
    cfg = ILQRConfig(max_iter=STRICT["max_iter"], tol=STRICT["tol"],
                     tol_grad=0.0, tol_grad_rel=0.0, exact_ls_delta=True,
                     backward_backend="pallas")
    x0s, us0 = scenario_inputs(B, T, torch.float32, 0, device)

    def solver(cfg_run, dev=device):
        return make_batch_solver(problem, cfg_run, engine="fused",
                                 device=dev)

    name = cuda_riccati.kernel_name(N, M, torch.float32)
    cuda_riccati.reset_launch_counts()
    res, solve_s = timed_call(solver(cfg), x0s, us0)
    counts = dict(cuda_riccati.launch_counts)
    passes = int(res.iterations.max())
    assert counts[name] == passes >= 1, (counts, passes)
    assert sum(counts.values()) == passes, counts
    assert res.us.dtype == torch.float32 and res.us.shape == (B, T, M)
    for f in (res.xs, res.us, res.cost):
        assert bool(torch.isfinite(f).all())

    cuda_riccati.reset_launch_counts()
    ref, scan_s = timed_call(solver(cfg.replace(backward_backend="scan")),
                             x0s, us0)
    assert cuda_riccati.launches() == 0
    assert torch.equal(res.status, ref.status), (
        lanes_by_status(res.status), lanes_by_status(ref.status))
    # Which pass a lane's sum((du)^2) first falls under 1e-6 is decided by
    # rounding on about a third of the lanes (phase solve's config stops on
    # the gradient test first): the plain version against the scan backend
    # on the CPU, these inputs, ended 68.8 % of the lanes on the same count.
    # Those lanes are held as phase solve holds them; the rest reported.
    same_it = res.iterations == ref.iterations
    frac_same = float(same_it.float().mean())
    assert frac_same > 0.5, frac_same
    us_rel = float((res.us[same_it] - ref.us[same_it]).abs().max()
                   / ref.us.abs().max())
    assert us_rel <= F32_SOLVE_REL_BOUND, us_rel

    x64, u64 = scenario_inputs(8, 24, torch.float64, 40, "cpu")
    f64 = card_against_cpu(
        lambda dev: solver(cfg, dev)(x64, u64), device,
        lambda: cuda_riccati.launch_counts[
            cuda_riccati.kernel_name(N, M, torch.float64)], "us")
    assert f64["launches"] == max(f64["iterations"]) >= 1, f64

    metrics = {k: float(v) for k, v in batch_metrics(res).items()}
    emit(phase="strict", B=B, T=T, n=N, m=M, dtype="float32",
         engine="fused", config=dict(STRICT, tol_grad=0.0, tol_grad_rel=0.0,
                                     exact_ls_delta=True),
         passes=passes, launches=counts, solve_s=solve_s,
         solves_per_s=B / solve_s, lanes_by_status=lanes_by_status(
             res.status),
         mean_iterations=metrics["mean_iterations"],
         max_iterations=passes, mean_cost=metrics["mean_cost"],
         tpu=STRICT_TPU,
         scan={"solve_s": scan_s, "status_equal": True,
               "lanes_same_iterations": frac_same,
               "us_rel_diff_same_lanes": us_rel,
               "bound": F32_SOLVE_REL_BOUND},
         f64=dict(B=8, T=24, **f64))
    return {name: counts[name]}


def rbd_ls_config(max_iter, T, backend="pallas"):
    """``bench.py --config rbd --ls-warm --ls-expected --ls-c 0.4``."""

    return rbd_config(max_iter, T, backend).replace(
        ls_expected_decrease=True, ls_c=RBD_LS["ls_c"],
        ls_alpha_warm_start=True)


def phase_rbd_ls(case, device):
    """``bench.py --config rbd --ls-warm --ls-expected --ls-c 0.4``: the
    RBD 2-DoF arm, B=256, T=100 (cut from 1000, as ``rbd_solve``), float32,
    ``make_chunked_batch_solver`` with ``bench.py``'s ``iter_chunk=10`` and
    ``snapshot_every=4``, the ``(16, 8)`` kernel.  One pass through each
    backend from the same state: the worst lane's ``us`` within
    F32_FIRST_PASS_REL_BOUND_RBD of max|us| and the same alpha on every
    lane (as ``rbd_solve``).  Then two passes through each, the second
    ladder starting from the carried alpha: the carried alpha equal on
    every lane.  ``max_iter`` is cut to what RBD_LS_BUDGET_S affords from
    the time of those two passes, at least 2 (printed): at 2 the two-pass
    kernel run is the solve, its launches set to 0 before and read after
    (launches equal passes).  Float64 at B=8, T=24, 2 passes in chunks of
    one (the alpha carried across a chunk boundary), card against CPU."""

    from ilqr_tpu_torch import batched
    from ilqr_tpu_torch.ops import cuda_riccati

    problem = case[0]
    n, m, B, T = (problem.state_dim, problem.control_dim, RBD_LS["B"],
                  RBD["T_cut"])
    name = cuda_riccati.kernel_name(n, m, torch.float32)
    print(f"chip_smoke: rbd_ls: T cut from {RBD['T']} to {T}, as in "
          f"rbd_solve", file=sys.stderr, flush=True)
    x0s, us0 = rbd_inputs(case, B, T, torch.float32, 0, device)
    us_bl = us0.movedim(0, -1).contiguous()
    xs_bl = batched.rollout_bl(problem, x0s.T.contiguous(), us_bl)
    cost0 = batched.total_cost_bl(problem, xs_bl, us_bl)
    xs0 = xs_bl.movedim(-1, 0).contiguous()

    def solve(max_iter, backend="pallas", dev=device, xs=xs0, us=us0,
              iter_chunk=RBD_LS["iter_chunk"], chunks=None):
        """``(result, seconds)`` of the chunked solve."""

        return timed_call(batched.make_chunked_batch_solver(
            problem, rbd_ls_config(max_iter, xs.shape[1] - 1, backend),
            iter_chunk=iter_chunk, device=dev,
            snapshot_every=RBD["snapshot_every"],
            on_chunk=None if chunks is None
            else lambda p, r: chunks.append((p, r))), xs, us)

    first_pass = compare_first_pass(solve(1)[0], solve(1, "scan")[0])
    chunks = []
    cuda_riccati.reset_launch_counts()
    res, solve_s = solve(2, chunks=chunks)
    counts = dict(cuda_riccati.launch_counts)
    two = solve(2, "scan")[0]
    assert torch.equal(res.iterations, two.iterations)
    assert torch.equal(res.alpha, two.alpha), (res.alpha, two.alpha)
    two_passes_s = solve_s

    max_iter = max(2, min(RBD["max_iter"],
                          int(RBD_LS_BUDGET_S / (solve_s / 2))))
    print(f"chip_smoke: rbd_ls: max_iter cut from {RBD['max_iter']} to "
          f"{max_iter} by the {RBD_LS_BUDGET_S} s budget"
          + (" (the two-pass run is the solve)" if max_iter == 2 else ""),
          file=sys.stderr, flush=True)
    if max_iter > 2:
        chunks = []
        cuda_riccati.reset_launch_counts()
        res, solve_s = solve(max_iter, chunks=chunks)
        counts = dict(cuda_riccati.launch_counts)
    passes = chunks[-1][0]
    by_status = check_rbd_result(res, cost0, B, T, n, m, torch.float32)
    assert counts[name] == passes >= 1, (counts, passes)
    assert sum(counts.values()) == passes, counts

    x64, u64 = rbd_inputs(case, 8, 24, torch.float64, 70, "cpu")
    xs64 = batched.rollout_bl(problem, x64.T.contiguous(),
                              u64.movedim(0, -1).contiguous()
                              ).movedim(-1, 0).contiguous()
    name64 = cuda_riccati.kernel_name(n, m, torch.float64)
    f64 = card_against_cpu(
        lambda dev: solve(2, dev=dev, xs=xs64, us=u64, iter_chunk=1)[0],
        device, lambda: cuda_riccati.launch_counts[name64], "us", "alpha")
    assert f64["launches"] == max(f64["iterations"]) >= 1, f64

    emit(phase="rbd_ls", B=B, T=T, T_config=RBD["T"], n=n, m=m,
         dtype="float32", ls_expected_decrease=True, ls_c=RBD_LS["ls_c"],
         ls_alpha_warm_start=True, iter_chunk=RBD_LS["iter_chunk"],
         snapshot_every=RBD["snapshot_every"], max_iter=max_iter,
         max_iter_config=RBD["max_iter"], budget_s=RBD_LS_BUDGET_S,
         two_passes_s=two_passes_s, passes=passes, chunks=chunks,
         launches=counts, solve_s=solve_s, lanes_by_status=by_status,
         mean_iterations=float(res.iterations.float().mean()),
         mean_cost_ratio=float((res.cost / cost0).mean()),
         carried_alpha={"mean": float(res.alpha.float().mean()),
                        "min": float(res.alpha.min())},
         after_first_pass=first_pass,
         after_second_pass={"alpha_equal": True,
                            "alpha_mean": float(two.alpha.mean())},
         f64=dict(B=8, T=24, passes_cap=2, iter_chunk=1, **f64))
    return {name: counts[name]}


def mpc_rbd_config(backend="scan"):
    """``bench.py --config mpc_batch --problem rbd``'s solver flags."""

    from ilqr_tpu_torch.config import ILQRConfig

    return ILQRConfig(max_iter=MPC_RBD["max_iter"], tol=1e-5,
                      tol_grad=1e-10, tol_grad_rel=1e-6, adaptive_reg=True, reg=1.0,
                      reg_min=1e-3, reg_scale=10.0, reg_backtrack_trigger=1,
                      backward_backend=backend)


def mpc_rbd_inputs(case, B, dtype, seed, device):
    """``[B, n]`` starts of the RBD fleet: ``bench.py``'s nominal state,
    its attitude perturbed by MPC_RBD["attitude"] and the base position and
    joints by MPC_RBD["pose"], at rest."""

    problem, nominal, _ = case
    n = problem.state_dim
    scale = torch.tensor([MPC_RBD["attitude"]] * 3
                         + [MPC_RBD["pose"]] * (n // 2 - 3) + [0.0] * (n // 2),
                         dtype=torch.float64)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    x0s = (torch.tensor(nominal, dtype=torch.float64)
           + scale * torch.randn((B, n), generator=gen, dtype=torch.float64))
    return x0s.to(dtype).to(device)


def phase_mpc_batch_rbd(case, device):
    """``bench.py --config mpc_batch --problem rbd``: ``batch_mpc_run`` of
    the RBD 2-DoF arm, B=64, H=50, float32, first with ``bench.py``'s
    backend (``"scan"``), then with ``"pallas"``, whose every replan
    iteration launches the batch-first entry of the ``(16, 8)``
    instantiation.  First one pass of the first replan (``solve`` from the
    fleet's starts and the zero warm start, rolled out) through each
    backend: the worst lane's ``us`` within F32_FIRST_PASS_REL_BOUND_RBD of
    max|us| and the same alpha on every lane (a whole replan of 10 passes
    amplifies the rounding past that: 5.4e-3 of max|u| on an H100).  Its
    time cuts the replans' ``max_iter`` from 10 and then ``n_steps`` from
    50, at least 2, so that the two runs fit MPC_RBD_BUDGET_S (both
    printed).  Launches equal passes and at least ``n_steps``; over the
    runs status equal on every lane and replan, the median lane's ``us``
    and the worst planned cost within the RBD solve bars (the worst lane
    printed); ms a replan and scenario-replans/s.  Float64 at B=2, H=10, 2
    steps of the cut ``max_iter``, card against CPU."""

    import functools

    from ilqr_tpu_torch.ops import cuda_riccati
    from ilqr_tpu_torch.parallel.mpc import batch_mpc_run
    from ilqr_tpu_torch.problem import problem_dynamics, rollout
    from ilqr_tpu_torch.solver import solve

    problem = case[0]
    n, m = problem.state_dim, problem.control_dim
    B, H, STEPS = MPC_RBD["B"], MPC_RBD["H"], MPC_RBD["n_steps"]
    x0s = mpc_rbd_inputs(case, B, torch.float32, 6, device)
    name = cuda_riccati.kernel_name(n, m, torch.float32)

    # One pass of the first replan through each backend.
    us_warm = torch.zeros((B, H, m), dtype=torch.float32, device=device)
    xs_warm = rollout(functools.partial(problem_dynamics, problem), x0s,
                      us_warm)
    one = {}
    for backend in ("scan", "pallas"):
        cuda_riccati.reset_launch_counts()
        one[backend] = timed_call(
            solve, problem, xs_warm, us_warm, None,
            mpc_rbd_config(backend).replace(max_iter=1), device)
        assert count_batch_first(name) == (backend == "pallas"), backend
    first_pass = compare_first_pass(one["pallas"][0], one["scan"][0])
    pass_s = one["pallas"][1]
    # A replan's later passes climb more rungs than the first: count each
    # pass 1.5 times; two runs of at least 2 steps.
    max_iter = max(1, min(MPC_RBD["max_iter"], int(
        MPC_RBD_BUDGET_S / (2 * 2 * 1.5 * pass_s))))
    n_steps = max(2, min(STEPS, int(
        MPC_RBD_BUDGET_S / (2 * max_iter * 1.5 * pass_s))))
    for what, cut, uncut in (("max_iter", max_iter, MPC_RBD["max_iter"]),
                             ("n_steps", n_steps, STEPS)):
        if cut < uncut:
            print(f"chip_smoke: mpc_batch_rbd: {what} cut from {uncut} to "
                  f"{cut} by the {MPC_RBD_BUDGET_S} s budget (one pass of "
                  f"the first replan took {pass_s:.1f} s)", file=sys.stderr,
                  flush=True)

    def run(backend, x=x0s, horizon=H, steps=n_steps, dev=device):
        return batch_mpc_run(problem, x, horizon, steps,
                             mpc_rbd_config(backend).replace(
                                 max_iter=max_iter), device=dev)

    def check(r):
        assert r.us.shape == (B, n_steps, m), r.us.shape
        assert r.xs.shape == (B, n_steps + 1, n), r.xs.shape
        assert r.us.dtype == torch.float32
        for f in (r.xs, r.us, r.costs):
            assert bool(torch.isfinite(f).all())

    cuda_riccati.reset_launch_counts()
    ref, scan_s = timed_call(run, "scan")
    assert cuda_riccati.launches() == 0
    cuda_riccati.reset_launch_counts()
    res, pallas_s = timed_call(run, "pallas")
    launches = count_batch_first(name)
    passes = int(res.iterations.max(dim=0).values.sum())
    assert launches == passes >= n_steps, (launches, passes)
    check(res)
    check(ref)
    assert torch.equal(res.statuses, ref.statuses), (res.statuses,
                                                     ref.statuses)
    lane_rel = ((res.us - ref.us).abs().amax(dim=(1, 2))
                / ref.us.abs().max())
    cost_rel = (res.costs - ref.costs).abs() / ref.costs.abs()
    median = float(lane_rel.median())
    assert median <= F32_SOLVE_MEDIAN_BOUND_RBD, median
    assert float(cost_rel.max()) <= F32_SOLVE_COST_BOUND_RBD, cost_rel.max()

    x64 = mpc_rbd_inputs(case, 2, torch.float64, 7, "cpu")
    name64 = cuda_riccati.kernel_name(n, m, torch.float64)
    f64 = card_against_cpu(
        lambda dev: run("pallas", x64, 10, 2, dev), device,
        lambda: count_batch_first(name64), "xs", "us", "costs")
    passes64 = int(torch.tensor(f64["iterations"]).max(dim=0).values.sum())
    assert f64["launches"] == passes64 >= 2, f64

    def rates(total_s):
        return {"total_s": total_s, "ms_per_replan": total_s / n_steps * 1e3,
                "scenario_replans_per_s": B * n_steps / total_s}

    emit(phase="mpc_batch_rbd", B=B, horizon=H, n=n, m=m, dtype="float32",
         n_steps=n_steps, n_steps_config=STEPS, max_iter=max_iter,
         max_iter_config=MPC_RBD["max_iter"], budget_s=MPC_RBD_BUDGET_S,
         first_replan_one_pass_s={b: t for b, (_, t) in one.items()},
         statuses=lanes_by_status(res.statuses),
         mean_iterations=float(res.iterations.float().mean()),
         passes=passes, batch_first_launches={name: launches},
         pallas=rates(pallas_s), scan=rates(scan_s),
         first_replan_first_pass=first_pass,
         vs_scan=dict(status_equal=True, median_lane_rel=median,
                      worst_lane_rel=float(lane_rel.max()),
                      worst_lane=int(lane_rel.argmax()),
                      worst_cost_rel=float(cost_rel.max()),
                      median_bound=F32_SOLVE_MEDIAN_BOUND_RBD,
                      cost_bound=F32_SOLVE_COST_BOUND_RBD),
         f64=dict(B=2, horizon=10, n_steps=2, **f64))
    return {name: launches, name64: f64["launches"]}


def ddp_inputs(B, T, seed, dtype, device):
    """``scripts/bench_ddp.py``'s 2-link scenarios: ``x0`` 0.2 and ``us0``
    0.01 times numpy's ``default_rng(seed)`` normals."""

    import numpy as np

    rng = np.random.default_rng(seed)
    x0 = 0.2 * rng.standard_normal((B, N))
    us0 = 0.01 * rng.standard_normal((B, T, M))
    return (torch.as_tensor(x0).to(dtype).to(device),
            torch.as_tensor(us0).to(dtype).to(device))


def phase_ddp(problem, device):
    """``scripts/bench_ddp.py``'s A/B: its four rows through
    ``make_batch_solver(engine="vmap")`` with ``"scan"`` (``ddp`` needs
    it), float32, at its B and config, T cut to DDP["T_cut"] (printed):
    converged, mean and max iterations, mean cost and seconds of each row
    beside the TPU log's (at T=100).
    ``ddp`` takes the second-order dynamics tensor from
    ``derivatives.dynamics_hessians`` into the recursion.  Then float64 at
    B=8, T=24 with ``ddp`` and ``reg_in_value``, card against CPU."""

    from ilqr_tpu_torch.config import ILQRConfig, Status
    from ilqr_tpu_torch.ops import cuda_riccati
    from ilqr_tpu_torch.parallel.batching import make_batch_solver

    B, T = DDP["B"], DDP["T_cut"]
    print(f"chip_smoke: ddp: T cut from {DDP['T']} to {T}, so that the "
          f"script fits its time", file=sys.stderr, flush=True)
    base = ILQRConfig(max_iter=DDP["max_iter"], tol=DDP["tol"],
                      exact_ls_delta=True)
    x0s, us0 = ddp_inputs(B, T, 0, torch.float32, device)
    rows = {}
    for label, flags in DDP_ROWS:
        cuda_riccati.reset_launch_counts()
        res, seconds = timed_call(make_batch_solver(
            problem, base.replace(**flags), engine="vmap", device=device),
            x0s, us0)
        assert cuda_riccati.launches() == 0
        assert res.us.shape == (B, T, M) and res.us.dtype == torch.float32
        for f in (res.xs, res.us, res.cost):
            assert bool(torch.isfinite(f).all()), label
        assert not bool((res.status == int(Status.RUNNING)).any()), label
        rows[label] = dict(
            converged=int((res.status == int(Status.CONVERGED)).sum()),
            lanes_by_status=lanes_by_status(res.status),
            mean_iterations=float(res.iterations.float().mean()),
            max_iterations=int(res.iterations.max()),
            mean_cost=float(res.cost.mean()), seconds=seconds)

    x64, u64 = ddp_inputs(8, 24, 1, torch.float64, "cpu")
    cfg64 = base.replace(ddp=True, reg_in_value=True)
    f64 = card_against_cpu(
        lambda dev: make_batch_solver(problem, cfg64, engine="vmap",
                                      device=dev)(x64, u64), device,
        lambda: cuda_riccati.launches(), "us")
    assert f64["launches"] == 0, f64
    emit(phase="ddp", B=B, T=T, T_config=DDP["T"], n=N, m=M,
         dtype="float32", engine="vmap",
         backward_backend="scan", config=dict(DDP, exact_ls_delta=True),
         rows=rows, tpu=DDP_TPU,
         f64=dict(B=8, T=24, ddp=True, reg_in_value=True, **f64))


# nvcc processes the background build runs at once (of the host's 8 cores).
BACKGROUND_NVCC = 3


@contextlib.contextmanager
def background_build(names):
    """Build the libraries ``names`` (``_build.build``: one ``nvcc`` each,
    BACKGROUND_NVCC at once) in a process of its own at the lowest
    priority, so that the phases run beside it on the host's other cores
    and lose little of their own.  Yields ``join()``, which waits for it, raises with the
    compiler's output if a build failed and returns ``{library: nvcc
    seconds}``.  On leaving the block whatever is left of the process and of
    the ``nvcc`` it started is killed."""

    import os
    import signal
    from pathlib import Path

    # BACKGROUND_NVCC at a time, the slowest (the cluster plans, 30 to 50 s
    # each) first: all at once, the phases beside them ran up to 4 times
    # slower on an H100's host.
    names = sorted(names, key=lambda n: not n.startswith("riccati_cluster"))
    code = ("import json, os, sys; os.nice(19); "
            "from ilqr_tpu_torch.ops import _build; "
            "k = int(sys.argv[1]); names = sys.argv[2:]; "
            "[_build.build(names[i:i + k]) for i in range(0, len(names), k)]; "
            "print(json.dumps(_build.build_seconds))")
    proc = subprocess.Popen([sys.executable, "-c", code, str(BACKGROUND_NVCC),
                             *names],
                            cwd=Path(__file__).resolve().parent,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)

    def join():
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"background build failed (exit "
                               f"{proc.returncode}):\n{err}")
        return json.loads(out.splitlines()[-1])

    try:
        yield join
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()


def ptxas_summary(_build, libraries=None):
    """``{kernel: "registers, spill bytes, shared memory"}`` from the logs
    of the build (``nvcc -Xptxas -v``), template arguments as the name."""

    out = {}
    for name in libraries or _build.SOURCES:
        if name.endswith("_clocks"):
            continue
        fn = None
        for ln in _build.log_path(name).read_text().splitlines():
            if "Compiling entry function" in ln:
                mangled = ln.split("'")[1]
                args = mangled.split("kernelI", 1)[-1].split("EEv", 1)[0]
                fn = f"{name}<{args.replace('Li', ',').replace('E', '')}>"
                out[fn] = ""
            elif fn and ("spill" in ln or "registers" in ln):
                out[fn] += ln.split(":", 1)[-1].strip() + "; "
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs on the card only", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--hashes"]:
        # python3 chip_smoke.py --hashes [ROOT]: the hashes of the fixed
        # instantiations only, of the port in ROOT (an older tree unpacked
        # beside this one) or of this one.
        if len(sys.argv) > 2:
            sys.path.insert(0, sys.argv[2])
        print(json.dumps({"hashes": instantiation_hashes(
            torch.device("cuda", torch.cuda.current_device()))}), flush=True)
        return 0
    if sys.argv[1:2] == ["--large-times"]:
        # python3 chip_smoke.py --large-times [ROOT]: the device times of
        # riccati_large.cu's instantiations only, of the port in ROOT (an
        # older tree unpacked beside this one) or of this one.
        if len(sys.argv) > 2:
            sys.path.insert(0, sys.argv[2])
        import ilqr_tpu_torch

        print(json.dumps({"large_times": large_times(
            torch.device("cuda", torch.cuda.current_device())),
            "package": ilqr_tpu_torch.__file__}), flush=True)
        return 0
    timed = {"--xl-times": ("xl_times", XL_TIMES, "riccati_xl"),
             "--cluster-times": ("cluster_times", CLUSTER_TIMES,
                                 "riccati_cluster")}
    if sys.argv[1:2] and sys.argv[1] in timed:
        # python3 chip_smoke.py --xl-times|--cluster-times [ROOT]: the
        # device times, hashes and stage clocks of one source's
        # instantiations only, of the port in ROOT (an older tree unpacked
        # beside this one) or of this one.
        key, rows, source = timed[sys.argv[1]]
        if len(sys.argv) > 2:
            sys.path.insert(0, sys.argv[2])
        import ilqr_tpu_torch

        print(json.dumps({key: source_times(
            torch.device("cuda", torch.cuda.current_device()), rows, source),
            "package": ilqr_tpu_torch.__file__}), flush=True)
        return 0
    t_start = time.perf_counter()

    from ilqr_tpu_torch.ops import _build
    from ilqr_tpu_torch.precision import resolve_device

    device = resolve_device(None)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    emit(phase="device", nvidia_smi=smi.splitlines(),
         torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0],
         tf32_matmul=torch.backends.cuda.matmul.allow_tf32)

    from ilqr_tpu_torch.ops import cuda_riccati

    t0 = time.perf_counter()
    # Every source with fixed instantiations and its stage-clock build, one
    # nvcc each, all together.
    fixed = list(_build.SOURCES) + list(_build.VARIANTS)
    _build.build(fixed)
    for name in _build.SOURCES:
        _build.load(name)
    # The instantiations of NEW_SHAPES and the stage-clock builds of the
    # float32 rows of riccati_large.cu and riccati_xl.cu (shapes): built in
    # the background while the phases that launch none of them run.
    instances = [cuda_riccati.library_and_symbol(n, m, dtype)[0]
                 for n, m in NEW_SHAPES for dtype in shape_types(n, m)]
    clocks = [f"{name}_clocks" for name in instances
              if name.startswith(tuple(f"{src}_" for src in ONE_LANE_A_BLOCK))
              and name.endswith("f32")]
    with background_build(instances + clocks) as join_instances:
        emit(phase="build", seconds=time.perf_counter() - t0,
             sources=sorted(SOURCE_FILES.values()), libraries=fixed,
             nvcc_seconds=dict(_build.build_seconds),
             ptxas=ptxas_summary(_build, fixed),
             building_in_background=instances + clocks)
        return run_phases(device, join_instances, instances, t_start)


def run_phases(device, join_instances, instances, t_start):
    """Every phase of the default run, then the ``total``, ``kernels`` and
    last lines.  The phases that launch an instantiation of NEW_SHAPES run
    after ``join_instances()``."""

    from ilqr_tpu_torch.config import ILQRConfig
    from ilqr_tpu_torch.models.two_link import make_two_link_problem
    from ilqr_tpu_torch.ops import _build

    problem = make_two_link_problem()
    config = ILQRConfig(max_iter=30, tol=1e-5, tol_grad=1e-10,
                        tol_grad_rel=1e-6, reg=1e-2,
                        backward_backend="pallas")

    rows = phase_kernels(problem, device)
    sources = dict.fromkeys(rows, KERNEL_SOURCE)
    phase_parity(problem, config, device)
    launches, fused, solve_cfg = phase_solve(problem, config, device)

    cases = {six: rbd_case(six) for six in (False, True)}
    wide_rows, one_pass_full = phase_rbd_kernels(cases, device)
    sources.update(dict.fromkeys(wide_rows, WIDE_SOURCE))
    rows.update(wide_rows)
    launches.update(phase_rbd_solve(cases[False], device, one_pass_full))
    launches.update(phase_rbd_parity(cases[False], device))
    launches.update(phase_rbd_6dof(cases[True], device))

    bf_rows = phase_batched_entry(problem, cases, device)
    bf_launches = phase_vmap_solve(problem, solve_cfg, fused, device)
    phase_single(problem, device)

    def add(into, counts):
        for name, count in counts.items():
            into[name] = into.get(name, 0) + count

    add(bf_launches, phase_mpc(problem, device))
    add(launches, phase_resilience(problem, solve_cfg, device))
    add(bf_launches, phase_mpc_chunked(problem, device))
    add(bf_launches, phase_long_horizon(problem, device))
    add(launches, phase_parallel_alpha(problem, solve_cfg, fused, device))
    al_launches, al_rows = phase_al(problem, device)
    add(bf_launches, al_launches)
    bf_rows.update(al_rows)
    phase_trace_profile(problem, device)
    add(launches, phase_strict(problem, device))
    add(launches, phase_rbd_ls(cases[False], device))
    add(bf_launches, phase_mpc_batch_rbd(cases[False], device))
    phase_ddp(problem, device)
    add(bf_launches, phase_sharded(problem, solve_cfg, device))
    phase_entry(device)
    phase_examples(device)

    # The phases that launch the instantiations built in the background.
    t0 = time.perf_counter()
    built = join_instances()
    for name in instances:
        _build.load(name)
    emit(phase="build_instances", waited_s=time.perf_counter() - t0,
         libraries=sorted(built), nvcc_seconds=built,
         ptxas=ptxas_summary(_build, sorted(built)))
    dual_launches, dual_rows = phase_rbd_dual(rbd_case("dual"), device)
    launches.update(dual_launches)
    sources.update(dict.fromkeys(dual_rows, XL_SOURCE))
    rows.update(dual_rows)
    five_launches, five_rows = phase_rbd_five(rbd_case("five"), device)
    launches.update(five_launches)
    sources.update(dict.fromkeys(five_rows, CLUSTER_SOURCE))
    rows.update(five_rows)
    shape_rows, shape_bf_rows = phase_shapes(device, built)
    al_rbd_launches, al_rbd_rows = phase_al_rbd(cases, device)
    add(bf_launches, al_rbd_launches)
    al_6dof_launches, al_6dof_rows = phase_al_6dof(cases, device)
    add(bf_launches, al_6dof_launches)
    marks = [("start", t_start)] + EMITTED
    emit(phase="total", seconds=time.perf_counter() - t_start,
         seconds_by_phase={p: t - t_prev for (_, t_prev), (p, t)
                           in zip(marks, marks[1:])})

    kernels = []
    for name, row in sorted(rows.items()):
        assert launches[name] >= 1, (name, launches)
        kernels.append(dict(
            name=name, route="cuda", source=sources[name],
            replaces=KERNEL_REPLACES, launches=launches[name],
            max_abs_err=row["max_abs_err"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"]))
    # The batch-first entry, at each instantiation its path launched: the
    # (17, 8) and (25, 12) rows from al_rbd's and al_6dof's own local models.
    bf_rows.update(shape_bf_rows)
    bf_rows.update(al_rbd_rows)
    bf_rows.update(al_6dof_rows)
    sources.update({name: SOURCE_FILES[row["source"]]
                    for name, row in shape_rows.items()})
    for name, count in sorted(bf_launches.items()):
        row = bf_rows[name]
        assert count >= 1, (name, bf_launches)
        kernels.append(dict(
            name=f"{name}_batch_first", route="cuda",
            source=sources.get(name, KERNEL_SOURCE),
            entry=BATCH_FIRST_ENTRY, replaces=BATCH_FIRST_REPLACES,
            launches=count, max_abs_err=row["max_abs_err"], ms=row["ms"],
            batch_last_ms=row["batch_last_ms"], layout_copies="none",
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"]))
    # The instantiations of NEW_SHAPES that no path of this run launched
    # (all but (17, 8) and (25, 12); those batch-last, and batch-first in
    # float64): rows of the shapes phase's checks, marked as such.
    for entry, shape_rows_e, counts in (("", shape_rows, launches),
                                        ("_batch_first", shape_bf_rows,
                                         bf_launches)):
        for name, row in sorted(shape_rows_e.items()):
            if counts.get(name, 0) >= 1:
                continue
            kernels.append(dict(
                name=f"{name}{entry}", route="cuda", source=sources[name],
                replaces=(BATCH_FIRST_REPLACES if entry
                          else KERNEL_REPLACES),
                launches=0, check_only=True,
                max_abs_err=row["max_abs_err"], ms=row["ms"],
                plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                bound_by=row["bound_by"], library_ms=row["library_ms"],
                padded=row["padded"], plan_bytes=row["plan_bytes"]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
