"""The port's examples (``examples/torch_*.py``) on the CPU, float64.

Each example's ``main`` runs with ``--cpu`` at a small ``--steps`` and
``--max-iter``, in float64 (PyTorch's default dtype set to float64, as the
JAX examples run in float64 under the suite's ``jax_enable_x64``):

* ``torch_two_link_open_loop.py`` against ``examples/two_link_open_loop.py``
  run the same way: the same printed line, the trajectory to rtol 1e-12
  (the same RK4 step, libm's last bit).
* ``torch_two_link_swingup.py`` against ``examples/two_link_swingup.py``:
  the same printed status and iterations (every printed line but the
  rounding of the costs' last digits), the final state and controls to
  rtol 1e-8, the bar of a whole float64 solve held against JAX on a
  scenario that does not amplify rounding (``ROADMAP.md`` C6).
* ``torch_rbd_arm.py`` against the port's own ``solver.solve`` with the
  same arguments, equal: the JAX RBD program takes minutes to build on a
  CPU (``ROADMAP.md`` C9), and its RBD model is held against the JAX one in
  ``tests/test_torch_rbd*.py``.

The 2-link runs hide matplotlib, as on a machine without it: the examples
then skip only the animation (rendering it would take most of the file's
time); the RBD run writes its animation and plot into ``tmp_path`` where
matplotlib is installed.  Without ``--cpu`` and without a card, an
example raises: there is no fall-back.
"""

import importlib.util
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.torch_parity import assert_close, to_numpy

torch.set_num_threads(1)

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def load(name):
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def recording(module, attr):
    """Wrap ``module.attr`` so that its results are kept in a list."""

    calls = []
    fn = getattr(module, attr)

    def wrapped(*args, **kw):
        out = fn(*args, **kw)
        calls.append(out)
        return out

    setattr(module, attr, wrapped)
    return calls


@pytest.fixture
def no_matplotlib(monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)


@pytest.fixture
def float64_default():
    before = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(before)


def run_jax(name, argv, monkeypatch, capsys, attr):
    """The JAX example ``name`` run as ``python examples/<name>.py argv``:
    ``(printed lines, results of its calls of attr)``."""

    module = load(name)
    calls = recording(module, attr)
    monkeypatch.setattr("sys.argv", [name] + argv)
    module.main()
    return capsys.readouterr().out.splitlines(), calls


def test_open_loop_matches_the_jax_example(float64_default, no_matplotlib,
                                           monkeypatch, capsys, tmp_path):
    argv = ["--steps", "60", "--cpu"]
    xs = load("torch_two_link_open_loop").main(
        argv + ["--out", str(tmp_path / "port.gif")])
    printed = capsys.readouterr()
    port_lines = printed.out.splitlines()
    assert "skipping animation" in printed.err
    jax_lines, calls = run_jax("two_link_open_loop",
                               argv + ["--out", str(tmp_path / "jax.gif")],
                               monkeypatch, capsys, "rollout")
    assert xs.dtype == torch.float64 and xs.device.type == "cpu"
    assert port_lines == jax_lines
    assert port_lines[0].startswith("rolled out 60 steps; final state")
    assert_close(xs, calls[0], 1e-12, 1e-14)


def costs_masked(lines):
    """The printed lines with every number after "Cost: " or "cost=" cut to
    five significant figures."""

    def cut(m):
        return f"{m.group(1)}{float(m.group(2)):.5g}"

    return [re.sub(r"(Cost: |cost=)([-+0-9.e]+)", cut, ln) for ln in lines]


def test_swingup_matches_the_jax_example(float64_default, no_matplotlib,
                                         monkeypatch, capsys, tmp_path):
    argv = ["--steps", "40", "--max-iter", "6", "--cpu"]
    res = load("torch_two_link_swingup").main(
        argv + ["--out", str(tmp_path / "port.gif")])
    port_lines = capsys.readouterr().out.splitlines()
    jax_lines, calls = run_jax(
        "two_link_swingup", argv + ["--out", str(tmp_path / "jax.gif")],
        monkeypatch, capsys, "solve_with_trace")
    jres = calls[0][0]
    assert res.xs.device.type == "cpu" and res.xs.dtype == torch.float64
    status = [ln for ln in port_lines if ln.startswith("status=")]
    assert len(status) == 1
    assert status[0].split()[:2] == [f"status={int(jres.status)}",
                                     f"iterations={int(jres.iterations)}"]
    assert costs_masked(port_lines) == costs_masked(jax_lines)
    assert int(res.iterations) == int(jres.iterations) >= 2
    assert_close(res.xs[-1], jres.xs[-1], 1e-8, 1e-10)
    assert_close(res.us, jres.us, 1e-8, 1e-10)


def test_rbd_arm_matches_the_port_solver(float64_default, capsys,
                                        tmp_path):
    from ilqr_tpu_torch.config import ILQRConfig
    from ilqr_tpu_torch.models.rbd.model import make_rbd_arm_problem
    from ilqr_tpu_torch.problem import rollout
    from ilqr_tpu_torch.solver import solve

    example = load("torch_rbd_arm")
    steps, max_iter = 20, 3
    gif, png = tmp_path / "rbd.gif", tmp_path / "rbd.png"
    res = example.main(["--steps", str(steps), "--max-iter", str(max_iter),
                        "--cpu", "--out", str(gif), "--png", str(png)])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if not ln.startswith("wrote")]
    if importlib.util.find_spec("matplotlib") is not None:
        assert gif.stat().st_size > 0 and png.stat().st_size > 0
    problem = make_rbd_arm_problem()
    x0 = example.initial_state("cpu")
    us0 = torch.zeros((steps, 8))
    ref = solve(problem, rollout(problem.dynamics, x0, us0), us0,
                config=ILQRConfig(max_iter=max_iter, **example.CONFIG),
                device="cpu")
    assert res.xs.dtype == torch.float64 and res.xs.shape == (steps + 1, 16)
    assert int(res.iterations) == int(ref.iterations) >= 1
    assert int(res.status) == int(ref.status)
    for name in ("xs", "us", "cost"):
        torch.testing.assert_close(getattr(res, name), getattr(ref, name),
                                   rtol=1e-12, atol=1e-12, msg=name)
    assert lines[-2] == (f"status={int(ref.status)} "
                         f"iterations={int(ref.iterations)}")
    assert lines[-1] == "final pose: " + str(
        [round(float(v), 3) for v in to_numpy(ref.xs[-1, :8])])
    assert sum(ln.startswith("Iteration: ") for ln in lines) == int(
        ref.iterations)


@pytest.mark.parametrize("name", ["torch_two_link_open_loop",
                                  "torch_two_link_swingup", "torch_rbd_arm"])
def test_examples_run_on_the_card_unless_told_otherwise(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the example would run on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load(name).main(["--steps", "5"])
