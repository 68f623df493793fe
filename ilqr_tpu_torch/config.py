"""Solver configuration.

The reference scatters its knobs across keyword arguments and hard-coded
constants (``max_iter``/``tol`` kwargs at src/forward_pass.jl:151-152;
line-search alpha0=1.0 and halving factor 2 at src/forward_pass.jl:66,82;
Tikhonov lambda=0.01 at src/backward_pass.jl:214).  Here they live in one
frozen, hashable dataclass.  This is the PyTorch port's own copy of
``ilqr_tpu/config.py`` (same fields, defaults and errors), kept here so that
the port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import enum
import warnings


class Status(enum.IntEnum):
    """Solver termination status.

    The reference has no status reporting: it asserts on NaN and loops
    forever if no improving step exists (src/forward_pass.jl:70-90).  Every
    failure mode here is a per-scenario flag instead, so one diverged solve
    in a batch of thousands is masked out rather than crashing the run.
    """

    RUNNING = 0
    CONVERGED = 1        # sum((u_new - u)^2) <= tol   (src/forward_pass.jl:171)
    MAX_ITER = 2         # iteration cap hit            (src/forward_pass.jl:161)
    LINESEARCH_FAILED = 3  # no alpha in the ladder decreased the cost


@dataclasses.dataclass(frozen=True)
class ILQRConfig:
    """Static solver configuration (frozen and hashable).

    Defaults replicate the reference solver exactly:

    * ``max_iter``/``tol`` — src/forward_pass.jl:151-152,
    * ``reg`` — the fixed Tikhonov term added to Quu before the gain solve,
      src/backward_pass.jl:214 (``H + 0.01 I``),
    * ``alpha0``/``alpha_factor`` — backtracking schedule 1, 1/2, 1/4, ...
      src/forward_pass.jl:66,82, accepting the first alpha with any cost
      decrease (src/forward_pass.jl:79),
    * ``max_backtracks`` — the reference backtracks unboundedly
      (``while true``, src/forward_pass.jl:70); we bound it at 32 halvings
      (alpha ~ 5e-10) and report ``LINESEARCH_FAILED`` instead of hanging.

    ``symmetrize`` re-symmetrizes the value Hessian each backward step; in
    exact arithmetic S is symmetric (src/backward_pass.jl:270), so this is a
    numerical-stability no-op that matters in float32.
    """

    max_iter: int = 100
    tol: float = 1e-6
    # Gradient-based convergence: stop when the backward pass's predicted
    # linear cost decrease |sum_t duff_t . Qu_t| falls below tol_grad.  The
    # reference has no such test — at an exact optimum its strict-decrease
    # line search loops forever (src/forward_pass.jl:70-87) — so this is 0.0
    # (disabled) by default for parity; set ~1e-12 for robust termination.
    tol_grad: float = 0.0
    # Relative gradient tolerance: converged when |dV1| <= tol_grad +
    # tol_grad_rel * cost.  This is the right scale in float32 — acceptance
    # compares costs, so a predicted decrease below ~eps_f32 * cost can never
    # be resolved by the line search and the iterate is converged to working
    # precision.  0.0 (disabled) by default for reference parity.
    tol_grad_rel: float = 0.0
    reg: float = 1e-2
    alpha0: float = 1.0
    alpha_factor: float = 0.5
    max_backtracks: int = 32
    symmetrize: bool = True
    # Adaptive regularization schedule (framework extension; the reference
    # hard-codes reg=0.01).  When enabled, reg is scaled up by reg_scale on a
    # failed line search and decayed back toward reg_min on success.
    adaptive_reg: bool = False
    reg_min: float = 1e-6
    reg_max: float = 1e6
    reg_scale: float = 10.0
    # Tassa-style escalation (only with adaptive_reg): an ACCEPTED step that
    # needed >= this many rejected alphas also raises reg — on stiff
    # problems (heavy terminal weights, attitude dynamics) a fixed tiny reg
    # produces overshooting steps that crawl at alpha ~ 0.1 forever; raising
    # reg until steps accept near alpha = 1 restores fast descent.  0
    # disables (only a fully failed ladder raises reg).
    reg_backtrack_trigger: int = 0
    # Backward-pass backend: "scan" (sequential Python loop over time in
    # plain PyTorch, reference-faithful), "pallas" (the name is kept from
    # the JAX package; here it means the hand-written fused CUDA kernel of
    # ops/cuda_riccati.py) or "associative" (parallel-in-time Riccati,
    # log-depth in the horizon; not ported yet, the engines raise on it).
    backward_backend: str = "scan"
    # Regularization semantics (framework extension; default replicates the
    # reference).  The reference computes gains from H + reg*I but feeds the
    # UNREGULARIZED H into the value recursion (src/backward_pass.jl:214
    # calls step_back with the raw H from :186) — a mixed recursion that is
    # not the minimization of any stage cost and therefore cannot be
    # expressed as an associative scan (the parallel-in-time backend's
    # O(reg) divergence).  With reg_in_value=True, H + reg*I is used
    # consistently in the gain solve AND the value update — algebraically
    # identical to adding reg/2*|du|^2 to every stage cost (a per-step
    # trust-region on the control correction, the standard Tassa/DDP "reg on
    # Quu" variant) — and the recursion becomes an exact Riccati recursion
    # again, so the sequential and associative backends agree to roundoff at
    # ANY reg (tested in tests/test_pit.py).  Honored by the scan and
    # associative backends; the fused kernel keeps reference semantics
    # (enforced in __post_init__).
    reg_in_value: bool = False
    # Full DDP (framework extension; the reference is pure iLQR — its
    # backward pass stops at the dynamics Jacobian,
    # src/backward_pass.jl:25-40).  When True, the Q-function blocks gain
    # the second-order dynamics terms, Qzz += sum_k Vx_{t+1}[k] *
    # d2f_k/dz dz, contracted inside the backward scan against the running
    # value gradient.  Costs one extra fwd-over-fwd derivative sweep per
    # iteration and T*n*(n+m)^2 floats of tensor storage; pays for itself
    # when curvature-dominated problems take fewer iterations (quadratic
    # local convergence vs iLQR's superlinear).  Scan backend only.
    ddp: bool = False
    # The JAX package's lax.scan unroll factor.  The port's time loops are
    # Python loops, so the field is accepted (one config object drives both
    # packages in a parity test) and ignored.
    scan_unroll: int = 8
    # Evaluate the fused engine's derivative sweep in serial chunks of this
    # many timesteps (0 = whole horizon at once).  Bounds the peak memory of
    # jacfwd intermediates for heavy dynamics at long horizons; agrees with
    # the unchunked sweep to rounding.
    derivative_chunk: int = 0
    # Return the pre-update trajectory when the convergence test fires, which
    # is what the reference does (the break at src/forward_pass.jl:171 runs
    # before the trajectory update at :174-175).  Set False to return the
    # newer (strictly better) iterate.
    reference_return_semantics: bool = True
    # High-resolution line-search acceptance: evaluate the SAME condition
    # "new cost < previous cost" (src/forward_pass.jl:79) as a sum of
    # per-timestep cost DIFFERENCES instead of a difference of two rounded
    # totals.  Nearby per-step costs subtract exactly in floating point
    # (Sterbenz), so the decrease resolves to ~eps * max_t L_t instead of
    # ~eps * sum_t L_t — in f32 this certifies true decreases that the
    # rounded-total comparison cannot see (the "f32 cost-resolution floor"
    # lanes of BENCH.md).  Additionally accepts a CONVERGING step: a
    # candidate bitwise identical to the iterate — at the optimum in f32
    # the gain step underflows the control update entirely (u + duff ==
    # u, delta == 0 exactly), which strict decrease would reject forever
    # although the f64 reference would accept the infinitesimal decrease
    # and certify sum((du)^2) <= tol on that very step (du_sq == 0).
    # Identical decisions wherever the rounded test already resolves;
    # default off for bit-parity with the reference acceptance order.
    exact_ls_delta: bool = False
    # Expected-decrease line-search acceptance (Tassa, Erez & Todorov,
    # IROS 2012, sec. II-F; framework extension, default off for parity
    # with the reference's any-decrease rule src/forward_pass.jl:79):
    # accept a rung only when the achieved decrease is at least ls_c of
    # the predicted decrease -(alpha dV1 + alpha^2 dV2) from the backward
    # pass.  On stiff problems (heavy terminal weights) any-decrease
    # accepts alpha ~ 2^-k crawl steps forever; the ratio test rejects
    # them, which (with adaptive_reg + reg_backtrack_trigger) drives reg
    # up until near-alpha=1 steps return.  A predicted decrease <= 0
    # falls back to any-decrease.
    ls_expected_decrease: bool = False
    ls_c: float = 0.1
    # Parallel-alpha line search (fused engine only): evaluate this many
    # ladder rungs TOGETHER as extra batch lanes in one closed-loop
    # rollout, then pick the FIRST accepting alpha per lane — decisions
    # identical to the sequential ladder (the reference's acceptance
    # order, src/forward_pass.jl:66-87), but the serial T-step scan runs
    # once per BLOCK of rungs instead of once per rung; blocks repeat
    # until every lane accepts or max_backtracks is exhausted.
    # 0 = sequential (default, bit-parity with the ladder).  Not ported
    # yet: the port's fused engine raises on a value > 0.
    parallel_alpha_block: int = 0
    # Warm-started line search (framework extension, default off for
    # reference parity: the reference resets alpha to 1 every iteration,
    # src/forward_pass.jl:66).  Each lane's ladder starts one rung ABOVE
    # its previously accepted alpha (capped at alpha0) instead of at
    # alpha0: on stiff problems the accepted alpha is strongly temporally
    # correlated, and a lane crawling at alpha ~ 2^-6 pays 1-2 rungs per
    # iteration instead of 7.  After a failed ladder the start resets to
    # alpha0 (the reg escalation changes the local model, so the old
    # alpha is stale).
    ls_alpha_warm_start: bool = False

    def __post_init__(self):
        if self.ls_alpha_warm_start and self.parallel_alpha_block > 0:
            raise ValueError(
                "ls_alpha_warm_start is not implemented for the "
                "parallel-alpha ladder (parallel_alpha_block > 0)")
        if self.ddp and self.backward_backend != "scan":
            raise ValueError(
                "ddp=True needs the sequential value gradient inside the "
                "recursion; only backward_backend='scan' supports it "
                f"(got {self.backward_backend!r})")
        if self.reg_in_value and self.backward_backend == "pallas":
            raise ValueError(
                "reg_in_value=True is not implemented by the Pallas backward "
                "kernel (it replicates the reference's mixed regularization "
                "semantics); use backward_backend='scan' or 'associative'")
        if (self.backward_backend == "associative" and self.reg > 0.0
                and not self.reg_in_value):
            # The reference's mixed recursion (regularized gains, raw-H value
            # update) is not the minimization of any stage cost, so it has no
            # associative form: results differ from the scan backend by
            # O(reg) (exact agreement at reg=0).  reg_in_value=True switches
            # both backends to the consistent trust-region semantics, which
            # IS associative — they then agree at any reg.  See
            # ilqr_tpu/pit.py for the derivation.
            warnings.warn(
                "backward_backend='associative' with reg="
                f"{self.reg} > 0: the parallel-in-time Riccati recursion "
                "differs from the sequential backend by O(reg); do not "
                "expect reference-exact trajectories.  Use reg=0 (with "
                "adaptive_reg or a PD cost), or reg_in_value=True (exact "
                "agreement at any reg under trust-region semantics).",
                stacklevel=2)

    def replace(self, **kw) -> "ILQRConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = ILQRConfig()
