#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's solves, on one GPU.

    python3 scripts/profile_torch_solve.py [--batch 4096] [--horizon 100]
    python3 scripts/profile_torch_solve.py --problem rbd [--batch 256]
                                           [--horizon 100]

Default (``--problem two_link``): runs ``ilqr_tpu_torch``'s fused batch-last
solve of perturbed 2-link swing-ups (float32, ``backward_backend="pallas"``:
the CUDA Riccati kernel) once to warm up and build the kernel, once timed,
and once under ``torch.profiler``.  Prints one JSON object: the card, the
solve's wall time, the device's busy and idle share of it (sum of kernel
times over wall time), the number of kernels launched, and the kernels that
took most of the device time.

``--problem rbd``: ONE pass (one ``ilqr_step``) of the floating-base 2-DoF
arm (n=16, m=8, float32, the benchmark's Tassa flags and scenario
distribution), the third of a solve, after two warm passes.  Prints the
same numbers for that pass, and the kernels launched by its parts profiled
on their own: one step of the rollout (one RK4 step of the dynamics on
``[16, B]``), one ``derivatives_bl`` sweep (the explicit sweep, the
default), one ``riccati_bl``, and one ``derivatives_bl`` sweep with the JVP
replay (``explicit_derivatives=False``) for comparison.

It fails without a CUDA device; it imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def kernel_rows(prof):
    """``(name, device microseconds, count)`` of the kernel rows only: the
    operator rows repeat their kernels' device time."""

    return [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]


def card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def profile_rbd_pass(args):
    from torch.profiler import ProfilerActivity, profile

    from ilqr_tpu_torch import batched
    from ilqr_tpu_torch.config import ILQRConfig
    from ilqr_tpu_torch.models.rbd import make_rbd_arm_problem
    from ilqr_tpu_torch.step import ilqr_step, initial_state

    B, T = args.batch or 256, args.horizon
    problem = make_rbd_arm_problem()
    gen = torch.Generator().manual_seed(args.seed)
    nominal = torch.tensor([0.0, 0.0, 1.0, 0.5, 0.75, 1.0, 0.0, 0.0]
                           + [0.0] * 8)
    scale = torch.tensor([0.02] * 3 + [0.05] * 5 + [0.0] * 8)
    x0 = (nominal + scale * torch.randn((B, 16), generator=gen)).T.cuda()
    us = torch.zeros((T, 8, B), device="cuda")
    config = ILQRConfig(max_iter=100, tol=1e-5, tol_grad=1e-10,
                        tol_grad_rel=1e-6, adaptive_reg=True, reg=1.0,
                        reg_min=1e-3, reg_scale=10.0, reg_backtrack_trigger=1,
                        backward_backend="pallas",
                        derivative_chunk=100 if T >= 500 else 0)
    engine = batched.make_batch_last_engine(problem, None, config)
    state = initial_state(batched.rollout_bl(problem, x0.contiguous(), us),
                          us, config, lane_shape=(B,))
    for _ in range(2):
        state = ilqr_step(engine, config, state)[0]

    def profiled(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows = kernel_rows(prof)
        return out, wall, rows

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # The parts, each on its own (small traces), then the whole pass.
    parts = {}
    _, w, rows = profiled(lambda: problem.dynamics(state.xs[0], state.us[0]))
    parts["rollout_step"] = (w, rows)
    models, w, rows = profiled(lambda: batched.derivatives_bl(
        problem, state.xs, state.us, chunk=config.derivative_chunk))
    parts["derivatives_bl"] = (w, rows)
    _, w, rows = profiled(lambda: batched.riccati_bl(
        *models, reg=state.reg, config=config))
    parts["riccati_bl"] = (w, rows)
    del models
    # The same sweep with the other form of the dynamics Jacobians: the JVP
    # replay through the custom forward-dynamics JVP.
    replay = make_rbd_arm_problem(explicit_derivatives=False)
    batched.derivatives_bl(replay, state.xs, state.us,
                           chunk=config.derivative_chunk)       # warm
    _, w, rows = profiled(lambda: batched.derivatives_bl(
        replay, state.xs, state.us, chunk=config.derivative_chunk))
    parts["derivatives_bl_jvp_replay"] = (w, rows)

    _, wall_s = timed(lambda: ilqr_step(engine, config, state))
    (_, aux), profiled_s, rows = profiled(
        lambda: ilqr_step(engine, config, state))
    device_us = sum(r[1] for r in rows)
    top = sorted(rows, key=lambda r: -r[1])[:8]
    print(json.dumps({
        "card": card(), "torch": torch.__version__, "problem": "rbd",
        "batch": B, "horizon": T, "dtype": "float32",
        "pass": 3, "ladder_rungs": int(aux.backtracks.max()) + 1,
        "pass_wall_s": wall_s, "profiled_wall_s": profiled_s,
        "device_busy_s": device_us / 1e6,
        "device_busy_share": device_us / 1e6 / profiled_s,
        "device_idle_share": 1.0 - device_us / 1e6 / profiled_s,
        "device_busy_share_of_unprofiled_wall": device_us / 1e6 / wall_s,
        "device_kernels_launched": sum(r[2] for r in rows),
        "parts": {k: {"profiled_wall_s": w,
                      "device_kernels_launched": sum(r[2] for r in rws),
                      "device_busy_s": sum(r[1] for r in rws) / 1e6}
                  for k, (w, rws) in parts.items()},
        "top_kernels": [{"name": k[:80], "device_ms": us_ / 1e3, "count": c}
                        for k, us_, c in top],
    }))
    return 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--problem", default="two_link",
                    choices=["two_link", "rbd"])
    ap.add_argument("--batch", type=int, default=None,
                    help="scenarios (default 4096; 256 for --problem rbd)")
    ap.add_argument("--horizon", type=int, default=100)
    ap.add_argument("--max-iter", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    if args.problem == "rbd":
        return profile_rbd_pass(args)
    args.batch = args.batch or 4096

    from torch.profiler import ProfilerActivity, profile

    from ilqr_tpu_torch.config import ILQRConfig
    from ilqr_tpu_torch.models.two_link import make_two_link_problem
    from ilqr_tpu_torch.parallel.batching import make_batch_solver

    gen = torch.Generator().manual_seed(args.seed)
    x0s = (torch.tensor([0.3, 0.7, 0.2, 0.5])
           + 0.1 * torch.randn((args.batch, 4), generator=gen)).cuda()
    us0 = torch.zeros((args.batch, args.horizon, 2), device="cuda")
    config = ILQRConfig(max_iter=args.max_iter, tol=1e-5, tol_grad=1e-10,
                        tol_grad_rel=1e-6, reg=1e-2,
                        backward_backend="pallas")
    solve = make_batch_solver(make_two_link_problem(), config, engine="fused")

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve(x0s, us0)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    run()
    res, wall_s = run()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, profiled_s = run()

    rows = kernel_rows(prof)
    device_us = sum(r[1] for r in rows)
    launches = sum(r[2] for r in rows)
    top = sorted(rows, key=lambda r: -r[1])[:8]
    print(json.dumps({
        "card": card(), "torch": torch.__version__,
        "batch": args.batch, "horizon": args.horizon, "dtype": "float32",
        "passes": int(res.iterations.max()),
        "solve_wall_s": wall_s, "solves_per_s": args.batch / wall_s,
        "profiled_wall_s": profiled_s,
        "device_busy_s": device_us / 1e6,
        "device_busy_share": device_us / 1e6 / profiled_s,
        "device_idle_share": 1.0 - device_us / 1e6 / profiled_s,
        "device_kernels_launched": launches,
        "top_kernels": [{"name": k[:80], "device_ms": us / 1e3, "count": c}
                        for k, us, c in top],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
