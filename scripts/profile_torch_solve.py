#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's headline solve, on one GPU.

    python3 scripts/profile_torch_solve.py [--batch 4096] [--horizon 100]

Runs ``ilqr_tpu_torch``'s fused batch-last solve of perturbed 2-link
swing-ups (float32, ``backward_backend="pallas"``: the CUDA Riccati kernel)
once to warm up and build the kernel, once timed, and once under
``torch.profiler``.  Prints one JSON object: the card, the solve's wall time,
the device's busy and idle share of it (sum of kernel times over wall time),
the number of kernels launched, and the kernels that took most of the device
time.  It fails without a CUDA device; it imports nothing of JAX.
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--horizon", type=int, default=100)
    ap.add_argument("--max-iter", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1

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

    # Kernel rows only: the operator rows repeat their kernels' device time.
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    device_us = sum(r[1] for r in rows)
    launches = sum(r[2] for r in rows)
    top = sorted(rows, key=lambda r: -r[1])[:8]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(json.dumps({
        "card": smi, "torch": torch.__version__,
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
