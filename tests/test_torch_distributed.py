"""The port's multi-process runtime helpers
(``ilqr_tpu_torch.parallel.distributed``), on the CPU.

* ``initialize_multihost``: ``num_processes=1`` does nothing; an explicit
  coordinator that nobody serves (a free port on 127.0.0.1) raises within a
  short ``initialization_timeout``, and never runs single-process; the
  automatic path with no cluster in the environment warns and stays
  single-process; with no card and no ``device`` it raises before any
  rendezvous (no silent fall-back to the CPU), so the Gloo ranks here pass
  ``device="cpu"``.
* In a real group of two Gloo ranks joined through ``initialize_multihost``
  (one group of processes, ``tests/torch_mp.py``): the global mesh spans
  both ranks, ``host_local_batch`` halves the batch, ``per_host_keys`` gives
  each rank its own numbers and the same numbers for the same seed, and
  ``make_global_scenario_array`` takes each rank's own lanes and refuses
  ranks that hold different counts.
"""

import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from ilqr_tpu_torch.parallel import distributed as d
from tests.torch_mp import run_ranks

torch.set_num_threads(1)


def test_num_processes_one_is_a_noop():
    # Must not raise and must not try to reach the coordinator.
    d.initialize_multihost(coordinator_address="nowhere:1", num_processes=1)
    assert not dist.is_initialized()


def test_unreachable_coordinator_raises():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError) as err:
        d.initialize_multihost(coordinator_address=f"127.0.0.1:{d.free_local_port()}",
                               num_processes=2, process_id=1,
                               initialization_timeout=2, device="cpu")
    assert time.monotonic() - t0 < 30, err.value
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="process_id"):
        d.initialize_multihost(coordinator_address="127.0.0.1:1",
                               num_processes=2)


def test_no_card_and_no_device_raises_before_the_rendezvous(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t0 = time.monotonic()
    # A coordinator nobody serves: the device is resolved first, so the
    # call raises at once instead of waiting out the rendezvous.
    with pytest.raises(RuntimeError, match="device='cpu'"):
        d.initialize_multihost(
            coordinator_address=f"127.0.0.1:{d.free_local_port()}",
            num_processes=2, process_id=0, initialization_timeout=60)
    assert time.monotonic() - t0 < 30
    assert not dist.is_initialized()
    # The launcher's variables set: the same, not a warning.
    for var, value in zip(d.LAUNCHER_ENV, ("127.0.0.1", "1", "2", "0")):
        monkeypatch.setenv(var, value)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        d.initialize_multihost()
    assert not dist.is_initialized()


def test_automatic_path_without_a_cluster(monkeypatch):
    for var in d.LAUNCHER_ENV:
        monkeypatch.delenv(var, raising=False)
    with pytest.warns(UserWarning, match="single-process"):
        d.initialize_multihost()
    assert not dist.is_initialized()
    # Asked for several processes, it raises instead.
    with pytest.raises(RuntimeError, match="refusing"):
        d.initialize_multihost(num_processes=2)
    assert not dist.is_initialized()


def test_single_process_helpers():
    assert d.host_local_batch(8) == 8
    a = torch.rand(5, generator=d.per_host_keys(3))
    b = torch.rand(5, generator=d.per_host_keys(3))
    assert torch.equal(a, b)


def test_two_ranks(tmp_path):
    ranks = run_ranks("distributed", 2, tmp_path)
    for r, out in enumerate(ranks):
        assert int(out["world"]) == 2 and int(out["rank"]) == r
        assert int(out["mesh_size"]) == 2 and str(out["backend"]) == "gloo"
        # The mesh runs on the group initialize_multihost made.
        assert bool(out["default_group"])
        assert int(out["local_batch"]) == 4
        np.testing.assert_array_equal(out["mine"], np.arange(4 * r, 4 * r + 4))
        assert "divide evenly" in str(out["uneven"])
        draws = out["draws"]
        # The same seed twice on a rank: the same numbers; another seed:
        # others.
        np.testing.assert_array_equal(draws[0], draws[1])
        assert not np.array_equal(draws[0], draws[2])
    # The same seed on the two ranks: different numbers.
    assert not np.array_equal(ranks[0]["draws"][0], ranks[1]["draws"][0])
    # Rank 0 of the group draws what a single process draws.
    np.testing.assert_array_equal(
        ranks[0]["draws"][0],
        torch.rand(4, generator=d.per_host_keys(7)).numpy())
