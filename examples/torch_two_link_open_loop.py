"""Open-loop rollout on the PyTorch/CUDA port: roll the passive 2-link arm
forward under zero torque and render the motion.

Counterpart of ``examples/two_link_open_loop.py`` (the JAX package's), with
the same arguments and the same printed lines.  Runs on the card unless
``--cpu`` is given (without a card and without ``--cpu`` it raises), in
PyTorch's default dtype.

    python examples/torch_two_link_open_loop.py [--steps 900] [--out open_loop.gif] [--cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from ilqr_tpu_torch.models.two_link import (TwoLinkParams, forward_kinematics,
                                            make_dynamics)
from ilqr_tpu_torch.precision import resolve_device
from ilqr_tpu_torch.problem import rollout


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=900)
    ap.add_argument("--out", type=str, default="two_link_open_loop.gif")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the host CPU instead of the card")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)

    params = TwoLinkParams()
    dynamics = make_dynamics(params)
    x0 = torch.tensor([0.1, -0.1, 0.0, 0.0], device=device)
    us = torch.zeros((args.steps, 2), device=device)
    xs = rollout(dynamics, x0, us)
    print(f"rolled out {args.steps} steps; final state "
          f"{[round(float(v), 4) for v in xs[-1]]}")

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.animation as animation
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib unavailable; skipping animation", file=sys.stderr)
        return xs

    xs_cpu = xs.detach().cpu().double()
    fig, ax = plt.subplots(figsize=(4, 4))
    ax.set_xlim(-2, 2); ax.set_ylim(-2, 2); ax.set_aspect("equal")
    line, = ax.plot([], [], "o-", lw=4, color="tab:blue", alpha=0.7)

    stride = max(1, len(xs_cpu) // 90)

    def draw(t):
        j1, tool = forward_kinematics(params, xs_cpu[t, :2])
        line.set_data([0.0, float(j1[0]), float(tool[0])],
                      [0.0, float(j1[1]), float(tool[1])])
        return (line,)

    ani = animation.FuncAnimation(fig, draw,
                                  frames=range(0, len(xs_cpu), stride),
                                  blit=True)
    ani.save(args.out, writer="pillow", fps=20)
    print(f"wrote {args.out}")
    return xs


if __name__ == "__main__":
    main()
