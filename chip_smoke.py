#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card (written for an H100, ``sm_90a``) and ``nvcc``; with no
card it exits non-zero and prints no result.  It imports nothing of JAX and
nothing of the JAX package.  Nothing falls back and nothing is swallowed:
any phase that fails ends the script with a traceback and a non-zero code.

Phases, one JSON line each:

1. ``device``   the card as ``nvidia-smi`` names it, torch and CUDA versions.
2. ``build``    ``nvcc`` builds ``ilqr_tpu_torch/ops/csrc/*.cu`` from the
                checkout (seconds), registers per kernel from ``ptxas``.
3. ``kernels``  the fused Riccati kernel against its plain PyTorch version on
                the card, on local models from ``derivatives_bl`` at a rolled
                out iterate: float64 at B=256, T=24 (rtol 1e-10), float32 and
                float64 at the main path's B=4096, T=100, float32 at a ragged
                B=4099, ``symmetrize`` on and off, scalar and per-lane
                ``reg``; then the kernel's time beside its bound and the
                plain version's time.
4. ``parity``   a small float64 solve on the card (kernel) against the same
                solve on the CPU (plain version): same status and
                iterations, ``us`` to rtol 1e-8.
5. ``solve``    the main path: ``make_batch_solver(problem, config,
                engine="fused")`` on 4096 perturbed 2-link swing-ups, T=100,
                float32, ``backward_backend="pallas"`` (the CUDA kernel).
                The kernel's launch count is set to 0 before and read after:
                it must equal the passes of the solve.  A short float64
                solve drives the float64 instantiation the same way.  Then
                the same float32 inputs through ``backward_backend="scan"``
                for comparison, and one more solve timed phase by phase.

Then one line with every kernel's numbers, and the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import torch

# Published peaks of one H100 SXM (NVIDIA's data sheet): device memory rate,
# float32 rate outside the tensor cores, and half of it for float64.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 33.5e12}

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


def emit(**kw):
    print(json.dumps(kw), flush=True)


def sync_time(fn, reps):
    """Median milliseconds of ``fn()`` by CUDA events, after one warm call."""

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


def riccati_bound_ms(T, B, dtype):
    """Least time for one launch: each input read once, each output written
    once, over the memory rate; the recursion's flops over the peak rate."""

    size = torch.empty((), dtype=dtype).element_size()
    per_step_in = N * N + N * M + N + M + N * N + M * N + M * M
    per_step_out = M + M * N
    values = B * (T * (per_step_in + per_step_out) + N + N * N + 1 + 2)
    bytes_ms = values * size / HBM_BYTES_PER_S * 1e3
    # Multiply-adds per lane and step, two flops each: B'S, B's, BtS A,
    # BtS B, Cholesky and the solves of 1+N right-hand sides, H duff and
    # the two sums, the s update, SA, HK, the S update.
    fma = (M * N * N + M * N + M * N * N + M * M * N
           + M * M * M // 3 + (1 + N) * M * M
           + M * M + 2 * M + N * (N + 3 * M)
           + N * N * N + M * M * N + N * N * (N + 3 * M))
    flops_ms = 2 * fma * T * B / PEAK_FLOPS[dtype] * 1e3
    return ((bytes_ms, "bytes") if bytes_ms >= flops_ms
            else (flops_ms, "operations"))


def rel_err(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


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
            assert r <= F32_REL_BOUND, (name, r, F32_REL_BOUND)
        worst_abs = max(worst_abs, float((g - w).abs().max()))
        worst_rel = max(worst_rel, r)
    return worst_abs, worst_rel


def phase_kernels(problem, device):
    from ilqr_tpu_torch.ops.cuda_riccati import (kernel_name,
                                                 riccati_scan_cuda_bl,
                                                 riccati_scan_plain_bl)

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
        ms = sync_time(lambda: riccati_scan_cuda_bl(*models, reg), 30)
        plain_ms = sync_time(lambda: riccati_scan_plain_bl(*models, reg), 3)
        bound_ms, bound_by = riccati_bound_ms(T, B, dtype)
        rows[kernel_name(N, M, dtype)] = dict(
            max_abs_err=max_abs, max_rel_err=max_rel, ms=ms,
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


def time_one_pass(problem, config, x0s, us0):
    """Seconds of the first pass, phase by phase, at full width."""

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
    xs = batched.rollout_bl(problem, x0s.T.contiguous(), us)
    state = initial_state(xs, us, config, lane_shape=(B,))
    models, t_d = timed(lambda: batched.derivatives_bl(problem, xs, us))
    (duffs, Ks, dv1, dv2), t_r = timed(
        lambda: batched.riccati_bl(*models, reg=state.reg, config=config))
    _, t_f = timed(lambda: batched.forward_pass_bl(
        problem, xs, us, duffs, Ks, state.prev_cost, None, config,
        dV1=dv1, dV2=dv2))
    return dict(derivatives_s=t_d, riccati_s=t_r, forward_s=t_f)


def phase_solve(problem, config, device):
    from ilqr_tpu_torch import batched
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
    spent = {"derivatives_bl": 0.0, "riccati_bl": 0.0, "forward_pass_bl": 0.0}
    originals = {k: getattr(batched, k) for k in spent}

    def wrap(name):
        fn = originals[name]

        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            spent[name] += time.perf_counter() - t0
            return out

        return timed

    try:
        for k in spent:
            setattr(batched, k, wrap(k))
        res2, timed_s = run(cfg, x0s, us0)
    finally:
        for k, fn in originals.items():
            setattr(batched, k, fn)
    assert torch.equal(res2.status, res.status)

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
               "bound": F32_SOLVE_REL_BOUND})
    return {"riccati_cuda_4x2_f32": counts["riccati_cuda_4x2_f32"],
            "riccati_cuda_4x2_f64": counts64["riccati_cuda_4x2_f64"]}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs on the card only", file=sys.stderr)
        return 1
    t_start = time.perf_counter()

    from ilqr_tpu_torch.config import ILQRConfig
    from ilqr_tpu_torch.models.two_link import make_two_link_problem
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

    t0 = time.perf_counter()
    _build.build()
    for name in _build.SOURCES:
        _build.load(name)
    ptxas = [ln.strip() for name in _build.SOURCES
             for ln in _build.log_path(name).read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    emit(phase="build", seconds=time.perf_counter() - t0,
         sources=[f"ilqr_tpu_torch/ops/csrc/{n}.cu" for n in _build.SOURCES],
         ptxas=ptxas)

    problem = make_two_link_problem()
    config = ILQRConfig(max_iter=30, tol=1e-5, tol_grad=1e-10,
                        tol_grad_rel=1e-6, reg=1e-2,
                        backward_backend="pallas")

    rows = phase_kernels(problem, device)
    phase_parity(problem, config, device)
    launches = phase_solve(problem, config, device)

    kernels = []
    for name, row in sorted(rows.items()):
        assert launches[name] >= 1, (name, launches)
        kernels.append(dict(
            name=name, route="cuda", source=KERNEL_SOURCE,
            replaces=KERNEL_REPLACES, launches=launches[name],
            max_abs_err=row["max_abs_err"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"]))
    emit(phase="total", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
