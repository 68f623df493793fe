"""Matmul precision policy and device choice.

A float32 matrix product on an NVIDIA card may run through the tensor cores
in TF32, which keeps about three decimal digits.  That is the right trade
for large neural-net products and catastrophic for a Riccati recursion over
hundreds of steps and for closed-loop rollouts: reduced-precision feedback
gains destabilize the rollout (the JAX package records NaN costs at T=300
under reduced-precision products, ``ilqr_tpu/precision.py``).  The solver's
own small products never reach a matmul (``ops/smallmat.py`` spells them as
multiply-and-sum), but user dynamics and costs may, so every public entry
point of the solver stack is wrapped with :func:`highest_precision`.

The pin sets and restores three switches:

* ``torch.backends.cuda.matmul.allow_tf32 = False``
* ``torch.backends.cudnn.allow_tf32 = False``
* ``torch.set_float32_matmul_precision("highest")``
"""

from __future__ import annotations

import contextlib
import functools

import torch


@contextlib.contextmanager
def full_precision():
    """Scope full float32 products (no TF32) around a block."""

    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def highest_precision(fn):
    """Decorator: run ``fn`` under :func:`full_precision`."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with full_precision():
            return fn(*args, **kwargs)

    return wrapped


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for another (``device="cpu"``, as the parity tests do).  Raises when no
    card is present and none other was asked for — there is no silent
    fall-back to the CPU."""

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "ilqr_tpu_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
