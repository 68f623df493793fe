"""The port as a package: it stands apart from JAX and the JAX package, its
configuration is the JAX package's field for field, and what it has not
ported raises instead of being ignored."""

import dataclasses
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from ilqr_tpu import config as jax_config
from ilqr_tpu_torch import config as port_config
from ilqr_tpu_torch.batched import (batched_solve_fused,
                                    make_batch_last_engine, riccati_bl)
from ilqr_tpu_torch.config import ILQRConfig, Status
from ilqr_tpu_torch.convert import config_from_fields
from ilqr_tpu_torch.models.two_link import make_two_link_problem
from ilqr_tpu_torch.parallel.batching import batch_solve, make_batch_solver
from ilqr_tpu_torch.precision import full_precision, resolve_device

torch.set_num_threads(1)  # several pytest workers share the cores

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_SOURCES = (sorted((ROOT / "ilqr_tpu_torch").rglob("*.py"))
                + [ROOT / "chip_smoke.py"]
                + sorted((ROOT / "examples").glob("torch_*.py")))

IMPORT_CHECK = """
import sys
sys.path.insert(0, {root!r})
import ilqr_tpu_torch, ilqr_tpu_torch.batched, ilqr_tpu_torch.convert
import ilqr_tpu_torch.parallel.batching, ilqr_tpu_torch.models
import ilqr_tpu_torch.ops._build, ilqr_tpu_torch.ops.cuda_riccati
import ilqr_tpu_torch.ops.linalg, ilqr_tpu_torch.models.rbd
import ilqr_tpu_torch.models.rbd.kinematics
import ilqr_tpu_torch.pit, ilqr_tpu_torch.al, ilqr_tpu_torch.constraints
import ilqr_tpu_torch.costs, ilqr_tpu_torch.parallel.mpc
import ilqr_tpu_torch.utils.checkpoint, ilqr_tpu_torch.utils.metrics
import ilqr_tpu_torch.utils.profiling
import ilqr_tpu_torch.parallel.mesh, ilqr_tpu_torch.parallel.distributed
import ilqr_tpu_torch.parallel.pipeline, ilqr_tpu_torch.entry
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "ilqr_tpu"))
assert not bad, bad
print("clean")
"""


def test_importing_the_port_imports_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", IMPORT_CHECK.format(root=str(ROOT))],
        capture_output=True, text=True, cwd=str(ROOT), timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


@pytest.mark.parametrize("path", PORT_SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_names_no_jax_import(path):
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|ilqr_tpu)(\.|\s|$)", re.MULTILINE)
    assert not pattern.search(path.read_text()), path
    assert "torch.compile" not in path.read_text()


def test_chip_smoke_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, cwd=str(ROOT),
                         timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_config_fields_and_defaults_equal_the_jax_dataclass():
    jf = dataclasses.fields(jax_config.ILQRConfig)
    pf = dataclasses.fields(port_config.ILQRConfig)
    assert [f.name for f in pf] == [f.name for f in jf]
    assert [f.default for f in pf] == [f.default for f in jf]
    assert [f.type for f in pf] == [f.type for f in jf]
    assert ({s.name: s.value for s in port_config.Status}
            == {s.name: s.value for s in jax_config.Status})
    assert dataclasses.asdict(port_config.DEFAULT_CONFIG) == dataclasses.asdict(
        jax_config.DEFAULT_CONFIG)
    # Frozen, hashable, replace() as in the JAX package.
    cfg = ILQRConfig().replace(max_iter=7)
    assert cfg.max_iter == 7 and hash(cfg) == hash(ILQRConfig(max_iter=7))
    with pytest.raises(dataclasses.FrozenInstanceError):
        cfg.max_iter = 8


def test_config_crosses_from_the_jax_dataclass():
    jc = jax_config.ILQRConfig(max_iter=30, tol=1e-5, tol_grad=1e-10,
                               tol_grad_rel=1e-6, backward_backend="pallas",
                               scan_unroll=8)
    pc = config_from_fields(jc)
    assert isinstance(pc, ILQRConfig)
    assert dataclasses.asdict(pc) == dataclasses.asdict(jc)
    assert config_from_fields(dataclasses.asdict(jc)) == pc
    with pytest.raises(ValueError, match="unknown"):
        config_from_fields({"max_iters": 3})


BAD_CONFIGS = [
    (dict(ls_alpha_warm_start=True, parallel_alpha_block=4), ValueError),
    (dict(ddp=True, backward_backend="pallas"), ValueError),
    (dict(reg_in_value=True, backward_backend="pallas"), ValueError),
]


@pytest.mark.parametrize("kw,exc", BAD_CONFIGS,
                         ids=["warm_start+parallel", "ddp+pallas",
                              "reg_in_value+pallas"])
def test_config_post_init_errors_match(kw, exc):
    with pytest.raises(exc) as jax_err:
        jax_config.ILQRConfig(**kw)
    with pytest.raises(exc) as port_err:
        ILQRConfig(**kw)
    assert str(port_err.value) == str(jax_err.value)


def test_config_associative_warning_matches():
    with pytest.warns(UserWarning, match="parallel-in-time"):
        ILQRConfig(backward_backend="associative")


UNPORTED = {
    "associative": dict(backward_backend="associative", reg=0.0),
    "reg_in_value": dict(reg_in_value=True),
    "ddp": dict(ddp=True),
    "parallel_alpha_block": dict(parallel_alpha_block=4),
}


@pytest.mark.parametrize("flag", sorted(UNPORTED))
def test_unported_flags_raise_and_name_the_flag(flag):
    """The JAX fused engine ignores the first three silently; the port
    refuses them, at the engine and through every entry point (they belong
    to the per-scenario engine in both packages, ROADMAP C1).  The fourth,
    the parallel-alpha ladder, is ported: the fused engine accepts it and
    makes the sequential ladder's decisions."""

    problem = make_two_link_problem()
    cfg = ILQRConfig(**UNPORTED[flag])
    x0s = torch.zeros((2, 4), dtype=torch.float64)
    us0 = torch.zeros((2, 3, 2), dtype=torch.float64)
    if flag == "parallel_alpha_block":
        make_batch_last_engine(problem, None, cfg)
        x0s = x0s + torch.tensor([0.3, 0.7, 0.2, 0.5], dtype=torch.float64)
        par = batch_solve(problem, x0s, us0, config=cfg, device="cpu")
        seq = batch_solve(problem, x0s, us0, config=ILQRConfig(),
                          device="cpu")
        for name, a, b in zip(par._fields, par, seq):
            assert torch.equal(a, b), name
        return
    with pytest.raises(NotImplementedError, match=flag):
        make_batch_last_engine(problem, None, cfg)
    with pytest.raises(NotImplementedError, match=flag):
        batch_solve(problem, x0s, us0, config=cfg, device="cpu")
    with pytest.raises(NotImplementedError, match=flag):
        batched_solve_fused(problem, torch.zeros((2, 4, 4),
                                                 dtype=torch.float64),
                            us0, config=cfg, device="cpu")


def test_per_scenario_engine_refuses_parallel_alpha():
    """The parallel-alpha ladder exists only in the fused engine; the
    per-scenario engine (and every entry point built on it) refuses the flag
    instead of measuring the sequential ladder under its name (ROADMAP
    C17)."""

    from ilqr_tpu_torch.solver import solve
    from ilqr_tpu_torch.step import make_scalar_engine

    problem = make_two_link_problem()
    cfg = ILQRConfig(parallel_alpha_block=4)
    x0s = torch.tensor([[0.3, 0.7, 0.2, 0.5]] * 2, dtype=torch.float64)
    us0 = torch.zeros((2, 3, 2), dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="parallel_alpha_block"):
        make_scalar_engine(problem, None, cfg)
    with pytest.raises(NotImplementedError, match="parallel_alpha_block"):
        batch_solve(problem, x0s, us0, config=cfg, engine="vmap",
                    device="cpu")
    with pytest.raises(NotImplementedError, match="fused"):
        solve(problem, torch.zeros((4, 4), dtype=torch.float64),
              us0[0], config=cfg, device="cpu")
    # derivative_chunk changes no result and stays accepted, as in JAX.
    make_scalar_engine(problem, None, ILQRConfig(derivative_chunk=8))


def test_unported_engine_and_backend_raise():
    problem = make_two_link_problem()
    g = torch.Generator().manual_seed(3)
    x0s = 0.3 * torch.randn((2, 4), generator=g, dtype=torch.float64)
    us0 = 0.1 * torch.randn((2, 3, 2), generator=g, dtype=torch.float64)
    cfg = ILQRConfig(max_iter=5)
    # engine="vmap" is ported: the per-scenario solver on the batch agrees
    # with the fused engine.
    fused = batch_solve(problem, x0s, us0, config=cfg, engine="fused",
                        device="cpu")
    for vmap in (batch_solve(problem, x0s, us0, config=cfg, engine="vmap",
                             device="cpu"),
                 make_batch_solver(problem, cfg, engine="vmap",
                                   device="cpu")(x0s, us0)):
        assert torch.equal(vmap.status, fused.status)
        assert torch.equal(vmap.iterations, fused.iterations)
        torch.testing.assert_close(vmap.us, fused.us, rtol=1e-10, atol=1e-12)
    with pytest.raises(NotImplementedError, match="no_such"):
        batch_solve(problem, x0s, us0, engine="no_such", device="cpu")
    with pytest.raises(NotImplementedError, match="no_such"):
        riccati_bl(*[None] * 9, reg=0.0,
                   config=ILQRConfig(backward_backend="no_such"))


def test_default_device_is_the_card_and_never_silently_the_cpu():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device(None)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_batch_solver(make_two_link_problem())


def test_precision_pin_sets_and_restores():
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32,
              torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        with full_precision():
            assert torch.backends.cuda.matmul.allow_tf32 is False
            assert torch.backends.cudnn.allow_tf32 is False
            assert torch.get_float32_matmul_precision() == "highest"
        assert torch.backends.cuda.matmul.allow_tf32 is True
        assert torch.backends.cudnn.allow_tf32 is True
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before[0]
        torch.backends.cudnn.allow_tf32 = before[1]
        torch.set_float32_matmul_precision(before[2])


def test_float32_solve_stays_float32_and_int32():
    """The headline dtype at a toy size on the CPU: the working float is
    kept through every where() with a Python-scalar branch."""

    problem = make_two_link_problem()
    g = torch.Generator().manual_seed(0)
    x0s = (torch.tensor([0.3, 0.7, 0.2, 0.5])
           + 0.1 * torch.randn((4, 4), generator=g)).float()
    us0 = torch.zeros((4, 12, 2), dtype=torch.float32)
    cfg = ILQRConfig(max_iter=6, tol=1e-5, tol_grad=1e-10, tol_grad_rel=1e-6,
                     backward_backend="pallas", adaptive_reg=True)
    res = batch_solve(problem, x0s, us0, config=cfg, device="cpu")
    for name in ("xs", "us", "cost", "reg", "alpha", "du_sq"):
        assert getattr(res, name).dtype == torch.float32, name
    assert res.status.dtype == res.iterations.dtype == torch.int32
    assert bool(torch.isfinite(res.cost).all())
    assert set(res.status.tolist()) <= {int(Status.CONVERGED),
                                        int(Status.MAX_ITER)}
    assert res.converged.dtype == torch.bool
