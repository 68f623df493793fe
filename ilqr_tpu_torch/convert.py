"""State carried between the JAX package and the port.

The solver has no weights.  What crosses is configuration and solver state:
a config object, the 2-link parameters, a parsed URDF (``Mechanism``), a
mid-solve ``StepState``, a result namedtuple (``SolverResult``,
``BackwardResult``, ``ForwardResult``, ``MPCResult``) and the nine
local-model arrays of ``derivatives_bl``.
Everything goes through numpy arrays and plain field names; nothing here
imports JAX or the JAX package.  Field dtypes are kept (int32 ``iteration``
and ``status``, the working float elsewhere), so a state round-trips.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from ilqr_tpu_torch.config import ILQRConfig
from ilqr_tpu_torch.models.rbd.urdf import JointSpec, LinkSpec, Mechanism
from ilqr_tpu_torch.models.two_link import TwoLinkParams
from ilqr_tpu_torch.precision import resolve_device
from ilqr_tpu_torch.step import StepState

LOCAL_MODEL_NAMES = ("As", "Bs", "qx", "ru", "Qxx", "Pux", "Ruu", "qxN", "QN")
_INT_FIELDS = ("iteration", "iterations", "status")


def _dataclass_from_fields(cls, obj):
    """Build ``cls`` from a mapping or any object with the same field names
    (extra entries of a mapping are an error; missing ones keep defaults)."""

    names = [f.name for f in dataclasses.fields(cls)]
    if isinstance(obj, Mapping):
        unknown = set(obj) - set(names)
        if unknown:
            raise ValueError(f"unknown {cls.__name__} fields: {sorted(unknown)}")
        return cls(**dict(obj))
    return cls(**{k: getattr(obj, k) for k in names if hasattr(obj, k)})


def config_from_fields(obj) -> ILQRConfig:
    """The port's ``ILQRConfig`` from a dict or from any object with the
    same fields, e.g. the JAX package's ``ILQRConfig``."""

    return _dataclass_from_fields(ILQRConfig, obj)


def two_link_params_from_fields(obj) -> TwoLinkParams:
    return _dataclass_from_fields(TwoLinkParams, obj)


def mechanism_from_fields(obj) -> Mechanism:
    """The port's ``Mechanism`` from any object with the same fields, e.g.
    the JAX package's (read by attribute, links and joints too), so that
    both packages can build a model from one parsed URDF."""

    return Mechanism(
        name=obj.name,
        links=tuple(_dataclass_from_fields(LinkSpec, l) for l in obj.links),
        joints=tuple(_dataclass_from_fields(JointSpec, j)
                     for j in obj.joints),
        parents=tuple(int(p) for p in obj.parents),
        gravity=tuple(float(g) for g in obj.gravity),
    )


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _from_numpy(name, x, device, dtype) -> torch.Tensor:
    want = torch.int32 if name in _INT_FIELDS else dtype
    # np.array copies: the source may be a read-only view of a JAX buffer.
    return torch.as_tensor(np.array(x), device=device).to(want)


def step_state_from_numpy(fields, device=None,
                          dtype=torch.float64) -> StepState:
    """A ``StepState`` from a mapping (or namedtuple) of numpy arrays in the
    engine's own layout (batch-last for the fused engine)."""

    device = resolve_device(device)
    if not isinstance(fields, Mapping):
        fields = fields._asdict()
    return StepState(**{k: _from_numpy(k, fields[k], device, dtype)
                        for k in StepState._fields})


def step_state_to_numpy(state: StepState) -> dict:
    return {k: _to_numpy(v) for k, v in state._asdict().items()}


def result_to_numpy(result) -> dict:
    """Any result namedtuple of either package — ``SolverResult``,
    ``BackwardResult``, ``ForwardResult``, ``MPCResult`` — as a dict of
    numpy arrays by field name."""

    return {k: _to_numpy(v) for k, v in result._asdict().items()}


def local_models_from_numpy(models, device=None, dtype=torch.float64):
    """The nine arrays of ``derivatives_bl`` (a sequence in the order
    ``LOCAL_MODEL_NAMES``, or a mapping by those names) as contiguous
    tensors on ``device``."""

    device = resolve_device(device)
    if isinstance(models, Mapping):
        models = [models[k] for k in LOCAL_MODEL_NAMES]
    if len(models) != len(LOCAL_MODEL_NAMES):
        raise ValueError(f"expected {len(LOCAL_MODEL_NAMES)} arrays "
                         f"{LOCAL_MODEL_NAMES}, got {len(models)}")
    return tuple(_from_numpy(k, x, device, dtype).contiguous()
                 for k, x in zip(LOCAL_MODEL_NAMES, models))
