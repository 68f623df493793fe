"""The two-stage phase pipeline of the port
(``ilqr_tpu_torch.parallel.pipeline``) on two Gloo ranks on localhost,
against the port's fused single-device solve and against the JAX
``ilqr_tpu.parallel.pipeline.pipelined_solve`` on two of the conftest's
virtual CPU devices, float64, the same numpy inputs.

The two configs of ``tests/test_pipeline.py`` at B=8, T=24, held as that
test holds the JAX pipeline: ``us`` to rtol 1e-6 / atol 1e-7, ``cost`` to
rtol 1e-6, ``status`` and ``iterations`` equal.  One group of processes runs
both configs (``tests/torch_mp.py``); every rank returns the whole batch in
the caller's order.  The references are computed while the ranks run.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_tpu.config import ILQRConfig as JaxConfig
from ilqr_tpu.models.two_link import make_two_link_problem as jax_two_link
from ilqr_tpu.parallel.pipeline import make_pipeline_mesh as jax_mesh
from ilqr_tpu.parallel.pipeline import pipelined_solve as jax_pipelined
from ilqr_tpu_torch.batched import batched_solve_fused, rollout_bl
from ilqr_tpu_torch.convert import config_from_fields
from ilqr_tpu_torch.models.two_link import make_two_link_problem
from ilqr_tpu_torch.parallel import pipeline
from tests.conftest import cpu_devices
from tests.torch_mp import PIPE, PIPE_FLAGS, ranks_running, scenarios

torch.set_num_threads(1)


def fused(flags):
    problem = make_two_link_problem()
    x0s, us0 = (torch.as_tensor(a) for a in scenarios(**PIPE))
    xs0 = rollout_bl(problem, x0s.T, us0.movedim(0, -1)).movedim(-1, 0)
    return batched_solve_fused(problem, xs0, us0,
                               config=config_from_fields(flags), device="cpu")


def jax_pipeline(flags):
    x0s, us0 = scenarios(**PIPE)
    res = jax_pipelined(jax_two_link(), jax_mesh(cpu_devices()),
                        jnp.asarray(x0s), jnp.asarray(us0),
                        config=JaxConfig(**flags))
    return {f: np.asarray(getattr(res, f)) for f in res._fields}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    with ranks_running("pipeline", 2,
                       tmp_path_factory.mktemp("pipeline")) as wait:
        refs = [fused(flags) for flags in PIPE_FLAGS]
        jax_refs = [jax_pipeline(flags) for flags in PIPE_FLAGS]
        return wait(), refs, jax_refs


def assert_matches(got, want):
    """``tests/test_pipeline.py``'s tolerances."""

    np.testing.assert_allclose(got["us"], want["us"], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got["cost"], want["cost"], rtol=1e-6)
    np.testing.assert_array_equal(got["status"], want["status"])
    np.testing.assert_array_equal(got["iterations"], want["iterations"])


@pytest.mark.parametrize("case", range(len(PIPE_FLAGS)),
                         ids=["fixed_reg", "adaptive_reg"])
def test_pipelined_matches_fused(results, case):
    ranks, refs, _ = results
    want = refs[case]
    for r in ranks:
        assert str(r["axis"]) == "pipeline"
        got = {f: r[f"{case}_{f}"] for f in want._fields}
        assert_matches(got, {f: getattr(want, f).numpy()
                             for f in want._fields})
    # Both ranks gathered the same whole batch.
    for f in want._fields:
        np.testing.assert_array_equal(ranks[0][f"{case}_{f}"],
                                      ranks[1][f"{case}_{f}"])


@pytest.mark.parametrize("case", range(len(PIPE_FLAGS)),
                         ids=["fixed_reg", "adaptive_reg"])
def test_pipelined_matches_jax(results, case):
    ranks, _, jax_refs = results
    want = jax_refs[case]
    for r in ranks:
        assert_matches({f: r[f"{case}_{f}"] for f in want}, want)


def test_the_pipeline_needs_two_ranks():
    import torch.distributed as dist

    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="2 ranks"):
        pipeline.make_pipeline_mesh()
    from ilqr_tpu_torch.parallel.mesh import ScenarioMesh

    one = ScenarioMesh(group=None, rank=0, size=1,
                       device=torch.device("cpu"), axis="pipeline")
    x0s, us0 = (torch.as_tensor(a) for a in scenarios(**PIPE))
    with pytest.raises(ValueError, match="2 ranks"):
        pipeline.pipelined_solve(make_two_link_problem(), one, x0s, us0)
