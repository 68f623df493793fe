"""2-link swing-up on the PyTorch/CUDA port: roll out an initial guess, fit,
render a GIF.

Counterpart of ``examples/two_link_swingup.py`` (the JAX package's), with the
same arguments and the same printed lines: open-loop rollout of zero torque
from [.1, -.1, 0, 0] for N=900 steps, iLQR fit to tol 1e-6, then an
animation of the arm converging onto the workspace target.  Runs on the
card unless ``--cpu`` is given (without a card and without ``--cpu`` it
raises: there is no silent fall-back), in PyTorch's default dtype (float32
unless the caller sets another, as the JAX example runs in JAX's).

    python examples/torch_two_link_swingup.py [--steps 900] [--out swingup.gif] [--cpu]
"""

import argparse
import math
import os
import sys

# Allow running the example without installing the package.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from ilqr_tpu_torch.config import ILQRConfig
from ilqr_tpu_torch.models.two_link import (
    TwoLinkParams,
    forward_kinematics,
    make_two_link_problem,
)
from ilqr_tpu_torch.precision import resolve_device
from ilqr_tpu_torch.problem import rollout
from ilqr_tpu_torch.utils.metrics import solve_with_trace


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=900)
    ap.add_argument("--out", type=str, default="two_link_swingup.gif")
    ap.add_argument("--max-iter", type=int, default=40)
    ap.add_argument("--png", type=str, default=None,
                    help="write a static arm-motion plot to this path")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the host CPU instead of the card")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)

    params = TwoLinkParams()
    problem = make_two_link_problem(params)
    x0 = torch.tensor([0.1, -0.1, 0.0, 0.0], device=device)
    us0 = torch.zeros((args.steps, 2), device=device)
    xs0 = rollout(problem.dynamics, x0, us0)

    config = ILQRConfig(max_iter=args.max_iter, tol=1e-6)
    result, trace = solve_with_trace(problem, xs0, us0, config=config,
                                     device=device)
    n = int(result.iterations)
    for i in range(n):
        c = float(trace.cost[i])
        print(f"Iteration: {i + 1}\tTotal Cost: "
              f"{'(stationary)' if math.isinf(c) else f'{c:.6f}'}"
              f"\talpha={float(trace.alpha[i]):.3g}")
    print(f"status={int(result.status)} iterations={n} "
          f"final cost={float(result.cost):.6f} "
          f"terminal joint err={float(problem.final_cost(result.xs[-1])):.3e}")

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.animation as animation
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib unavailable; skipping animation", file=sys.stderr)
        return result

    xs = result.xs.detach().cpu().double()
    fig, ax = plt.subplots(figsize=(4, 4))
    ax.set_xlim(-2, 2); ax.set_ylim(-2, 2); ax.set_aspect("equal")
    ax.plot(params.target_x, params.target_y, "g*", markersize=12)
    line, = ax.plot([], [], "o-", lw=4, color="tab:red", alpha=0.7)

    def arm(t):
        j1, tool = forward_kinematics(params, xs[t, :2])
        return ([0.0, float(j1[0]), float(tool[0])],
                [0.0, float(j1[1]), float(tool[1])])

    stride = max(1, len(xs) // 90)

    def draw(t):
        line.set_data(*arm(t))
        return (line,)

    ani = animation.FuncAnimation(fig, draw, frames=range(0, len(xs), stride),
                                  blit=True)
    ani.save(args.out, writer="pillow", fps=20)
    print(f"wrote {args.out}")

    if args.png:
        # Arm poses fading in over the motion.
        fig2, ax2 = plt.subplots(figsize=(4.5, 4.5))
        ax2.set_xlim(-2, 2); ax2.set_ylim(-2, 2); ax2.set_aspect("equal")
        ax2.plot(params.target_x, params.target_y, "g*", markersize=14,
                 zorder=5)
        n_pose = 24
        idx = np.linspace(0, len(xs) - 1, n_pose).astype(int)
        for rank, t in enumerate(idx):
            a = 0.08 + 0.92 * rank / (n_pose - 1)
            ax2.plot(*arm(int(t)), "o-", lw=2.5, color="tab:red", alpha=a)
        ax2.set_title("2-link swing-up: converged iLQR motion\n"
                      "(opacity = time; star = workspace target)")
        fig2.savefig(args.png, dpi=110, bbox_inches="tight")
        print(f"wrote {args.png}")
    return result


if __name__ == "__main__":
    main()
