"""Floating-base URDF arm on the PyTorch/CUDA port (the reference's
RBD_2_link example).

Counterpart of ``examples/rbd_arm.py`` (the JAX package's), with the same
arguments and the same printed lines: load the 2-DoF arm URDF as a
floating-base mechanism (zero gravity), roll out zero torques from the
example's initial pose, fit with iLQR toward the 8-D target pose, report
per-iteration costs, and (with ``--out``) render a 3-D stick-figure
animation of the link frames via world-frame forward kinematics.  Runs on
the card unless ``--cpu`` is given (without a card and without ``--cpu`` it
raises: there is no silent fall-back), in PyTorch's default dtype.

    python examples/torch_rbd_arm.py [--steps 1000] [--max-iter 50] [--cpu]
"""

import argparse
import math
import os
import sys

# Allow running the example without installing the package.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from ilqr_tpu_torch.config import ILQRConfig
from ilqr_tpu_torch.models.rbd.model import make_rbd_arm_problem
from ilqr_tpu_torch.precision import resolve_device
from ilqr_tpu_torch.problem import rollout
from ilqr_tpu_torch.utils.metrics import solve_with_trace

# Tassa reg escalation: the setting under which this problem converges in
# about 40 iterations (the reference's fixed reg=0.01 crawls instead).
CONFIG = dict(tol=1e-5, tol_grad=1e-10, tol_grad_rel=1e-6, scan_unroll=1,
              adaptive_reg=True, reg=1.0, reg_min=1e-3, reg_scale=10.0,
              reg_backtrack_trigger=1)


def initial_state(device):
    """Quaternion [0,0,0,1] (180 deg about z -> MRP [0,0,1]), base at
    (.5,.75,1), joints at zero, zero velocity (RBD_helper_functions.jl:9)."""

    return torch.cat([torch.tensor([0.0, 0.0, 1.0]),
                      torch.tensor([0.5, 0.75, 1.0]),
                      torch.zeros(2), torch.zeros(8)]).to(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--max-iter", type=int, default=50)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the host CPU instead of the card")
    ap.add_argument("--out", type=str, default=None,
                    help="write a 3-D animation GIF to this path")
    ap.add_argument("--png", type=str, default=None,
                    help="write a static trajectory plot to this path")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)

    problem = make_rbd_arm_problem()  # target pose [0,0,0, 5,1,2, 1,.3]
    x0 = initial_state(device)
    us0 = torch.zeros((args.steps, 8), device=device)
    xs0 = rollout(problem.dynamics, x0, us0)

    config = ILQRConfig(max_iter=args.max_iter, **CONFIG)
    result, trace = solve_with_trace(problem, xs0, us0, config=config,
                                     device=device)

    n = int(result.iterations)
    for i in range(n):
        c = float(trace.cost[i])
        # inf marks an iteration whose ladder was skipped (stationarity
        # gate): there is no candidate cost to print.
        print(f"Iteration: {i + 1}\tTotal Cost: "
              f"{'(stationary)' if math.isinf(c) else f'{c:.6f}'}")
    final_pose = result.xs[-1, :8]
    print(f"status={int(result.status)} iterations={n}")
    print("final pose:", [round(float(v), 3) for v in final_pose])

    if args.out:
        _animate(result.xs, args.out)
    if args.png:
        _plot_trajectory(result.xs, args.png)
    return result


def _matplotlib():
    """``pyplot`` and ``animation`` on the Agg backend, or None."""

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.animation as animation
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib unavailable; skipping animation", file=sys.stderr)
        return None
    return plt, animation


def _plot_trajectory(xs, out_path):
    """Static plot: base position, joints and attitude against time."""

    mpl = _matplotlib()
    if mpl is None:
        return
    plt = mpl[0]
    xs = xs.detach().cpu().double().numpy()
    t = [k * 0.01 for k in range(len(xs))]
    fig, axes = plt.subplots(1, 3, figsize=(12, 3.5), constrained_layout=True)
    for i, (lbl, tgt) in enumerate(zip("xyz", [5.0, 1.0, 2.0])):
        axes[0].plot(t, xs[:, 3 + i], label=f"base {lbl}")
        axes[0].axhline(tgt, ls="--", lw=0.8, color="gray")
    axes[0].set(title="base position [m]", xlabel="t [s]")
    axes[0].legend(loc="best", fontsize=8)
    for j, tgt in enumerate([1.0, 0.3]):
        axes[1].plot(t, xs[:, 6 + j], label=f"joint {j}")
        axes[1].axhline(tgt, ls="--", lw=0.8, color="gray")
    axes[1].set(title="joint angles [rad]", xlabel="t [s]")
    axes[1].legend(loc="best", fontsize=8)
    for i, lbl in enumerate("xyz"):
        axes[2].plot(t, xs[:, i], label=f"MRP {lbl}")
        axes[2].axhline(0.0, ls="--", lw=0.8, color="gray")
    axes[2].set(title="attitude (MRP)", xlabel="t [s]")
    axes[2].legend(loc="best", fontsize=8)
    fig.suptitle("RBD floating-base arm: converged iLQR trajectory "
                 "(targets dashed)")
    fig.savefig(out_path, dpi=110)
    print(f"wrote {out_path}")


def _animate(xs, out_path):
    mpl = _matplotlib()
    if mpl is None:
        return
    plt, animation = mpl

    from ilqr_tpu_torch.models.rbd.kinematics import forward_kinematics
    from ilqr_tpu_torch.models.rbd.model import (TWO_DOF_ARM_URDF,
                                                 mrp_to_rbd_state)
    from ilqr_tpu_torch.models.rbd.urdf import parse_urdf

    mech = parse_urdf(TWO_DOF_ARM_URDF, floating=True,
                      gravity=(0.0, 0.0, 0.0))
    xs = xs.detach().cpu().double()
    stride = max(1, len(xs) // 90)
    q = mrp_to_rbd_state(xs[::stride])[:, :mech.nq]
    # Link positions [frames, links, 3].
    frames = torch.stack([p for _, p in forward_kinematics(mech, q)],
                         dim=1).numpy()

    fig = plt.figure(figsize=(5, 5))
    ax = fig.add_subplot(projection="3d")
    lo, hi = frames.min() - 0.5, frames.max() + 0.5
    ax.set_xlim(lo, hi); ax.set_ylim(lo, hi); ax.set_zlim(lo, hi)
    ax.scatter([5.0], [1.0], [2.0], marker="*", s=120, color="green")
    line, = ax.plot([], [], [], "o-", lw=3, color="tab:red")

    def draw(i):
        p = frames[i]
        line.set_data(p[:, 0], p[:, 1])
        line.set_3d_properties(p[:, 2])
        return (line,)

    ani = animation.FuncAnimation(fig, draw, frames=len(frames))
    ani.save(out_path, writer="pillow", fps=20)
    print(f"wrote {out_path}")


if __name__ == "__main__":
    main()
