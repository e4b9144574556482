"""Solver options.

JAX analogue of ``IPMOptions`` (reference: src/utils.jl:69-119) plus the
pluggable strategy objects (reference: src/utils.jl:1-48):

- step rules: ``ConservativeStep`` / ``AdaptiveStep`` / ``MehrotraAdaptiveStep``
- regularization: ``NoRegularization`` / ``FixedRegularization`` /
  ``AdaptiveRegularization``
- barrier update: ``Mehrotra``

Strategies are plain frozen dataclasses; they are consumed as *static*
configuration by the jitted step function (they select traced code paths, so a
change of strategy retriggers compilation — the natural XLA analogue of Julia's
dispatch-on-strategy-type).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional


# ---------------------------------------------------------------------------
# Strategy objects
# ---------------------------------------------------------------------------


class StepRuleKind(enum.Enum):
    CONSERVATIVE = "conservative"
    ADAPTIVE = "adaptive"
    MEHROTRA_ADAPTIVE = "mehrotra_adaptive"


@dataclasses.dataclass(frozen=True)
class ConservativeStep:
    """Fixed fraction-to-boundary factor tau (reference: src/utils.jl:19-21)."""

    tau: float = 0.995
    kind: StepRuleKind = StepRuleKind.CONSERVATIVE


@dataclasses.dataclass(frozen=True)
class AdaptiveStep:
    """tau = max(1 - mu, tau_min) (reference: src/utils.jl:23-25, src/kernels.jl:299-305)."""

    tau_min: float = 0.99
    kind: StepRuleKind = StepRuleKind.ADAPTIVE


@dataclasses.dataclass(frozen=True)
class MehrotraAdaptiveStep:
    """Mehrotra's boundary-point heuristic, Procedure GTSF
    (reference: src/utils.jl:27-29, src/kernels.jl:307-358)."""

    gamma_f: float = 0.99
    kind: StepRuleKind = StepRuleKind.MEHROTRA_ADAPTIVE


@dataclasses.dataclass(frozen=True)
class NoRegularization:
    """del_w = del_c = 0 in the loop (reference: src/kernels.jl:364-374)."""


@dataclasses.dataclass(frozen=True)
class FixedRegularization:
    """Constant (delta_p, delta_d); delta_d is negative
    (reference: src/utils.jl:39-42, src/kernels.jl:376-386)."""

    delta_p: float = 1e-10
    delta_d: float = 1e-10  # NOTE: applied with its own sign, like the reference

    def __post_init__(self):
        # The reference default is FixedRegularization(1e-10, 1e-10): the dual
        # regularization enters the KKT matrix as `du_diag = del_c` directly.
        pass


@dataclasses.dataclass(frozen=True)
class AdaptiveRegularization:
    """Decay delta/10 each iteration down to delta_min
    (reference: src/utils.jl:44-48, src/kernels.jl:388-401)."""

    delta_p: float = 1e-8
    delta_d: float = -1e-8
    delta_min: float = 1e-9


@dataclasses.dataclass(frozen=True)
class Mehrotra:
    """Mehrotra centering: sigma = clamp((mu_aff/mu)^power, sigma_min, sigma_max)
    (reference: src/utils.jl:10-11, src/kernels.jl:210-220; the reference
    hard-codes power=3 and clamp [1e-6, 10])."""

    power: float = 3.0
    sigma_min: float = 1e-6
    sigma_max: float = 10.0


# ---------------------------------------------------------------------------
# KKT-system / linear-solver selection
# ---------------------------------------------------------------------------


class KKTSystem(enum.Enum):
    """Which linear-system formulation the solver factorizes each iteration.

    - NORMAL: normal equations A Sigma^-1 A' (LP only), SPD of size m.
      (reference: src/KKT/normalkkt.jl)
    - AUGMENTED: K2 augmented system [Sigma+Q A'; A del_c], quasi-definite.
      (reference: MadNLP.SparseKKTSystem selected via IPMOptions.kkt_system)
    - SCALED_AUGMENTED: K2.5 — the augmented system symmetrically scaled by
      |diag|^-1/2 before the low-precision factorization (the conditioning
      role of the reference's ScaledSparseKKTSystem and its special
      positive-diagonal set_aug_diagonal_reg!, src/kernels.jl:138-149).
    - CONDENSED: K1 — eliminate the dual block through the (relaxed)
      equality regularization: ``(Sigma + Q + gamma A'A) dx = rx + gamma
      A' rp`` with ``gamma = 1/|del_c|``, then ``dy = -gamma (rp - A dx)``.
      SPD of size n — the primal-space analogue of MadNLP's
      SparseCondensedKKTSystem (selected via IPMOptions.kkt_system,
      src/utils.jl:71,110; exercised in test/test_gpu.jl:9-11), whose
      RelaxEquality treatment this masked-dense gamma-relaxation replaces.
      Supports LP and QP; its payoff is QPs — one SPD size-n Cholesky per
      iteration instead of the size-(n+m) quasi-definite LDL' of K2.
      |del_c| is floored at 1e-8: the relaxation IS the formulation, so it
      cannot be arbitrarily small.
    The device compute path is dense-blocked either way; sparse inputs are
    packed on host.
    """

    NORMAL = "normal"
    AUGMENTED = "augmented"
    SCALED_AUGMENTED = "scaled_augmented"
    CONDENSED = "condensed"


class LinearSolver(enum.Enum):
    """Factorization backend for the KKT matrix.

    - CHOLESKY: dense (blocked) Cholesky of the SPD normal matrix.
    - CHOLESKY_INV: recursive blocked Cholesky producing the explicit
      inverse factor L^-1 (ops/block_chol.py) — solves become two
      matmuls instead of sequential triangular solves.
    - LDL: dense unpivoted LDL' of the quasi-definite augmented matrix.
    - LU: dense LU with partial pivoting (robust fallback).
    Replaces the reference's pluggable direct solvers (cuDSS/Ma57/CHOLMOD/
    LDLFactorizations/Lapack; reference: src/linear_solver.jl, src/utils.jl:54-62).
    """

    CHOLESKY = "cholesky"
    CHOLESKY_INV = "cholesky_inv"
    LDL = "ldl"
    LDL_INV = "ldl_inv"  # matmul-only LDL' with explicit inverse
    LU = "lu"


class PrintLevel(enum.IntEnum):
    """Mirror of MadNLP log levels (reference: src/utils.jl:75-76)."""

    TRACE = 1
    DEBUG = 2
    INFO = 3
    NOTICE = 4
    WARN = 5
    ERROR = 6


# ---------------------------------------------------------------------------
# IPMOptions
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class IPMOptions:
    """Options for the Mehrotra predictor-corrector solver.

    Field-for-field capability match with the reference ``IPMOptions``
    (src/utils.jl:69-105); defaults follow the reference.
    """

    # Main options
    tol: float = 1e-8
    kkt_system: Optional[KKTSystem] = None  # None = auto (NORMAL for LP, AUGMENTED for QP)
    linear_solver: Optional[LinearSolver] = None  # None = auto from kkt_system

    # Output options
    output_file: str = ""
    print_level: PrintLevel = PrintLevel.INFO
    file_print_level: PrintLevel = PrintLevel.INFO
    rethrow_error: bool = False

    # Termination options
    # NOTE: the reference also declares `kappa_d`, an IPMOptions-level
    # `tau_min`, and `mu_superlinear_decrease_power` (src/utils.jl:82,100-101)
    # but never consumes them anywhere in its source; they are deliberately
    # NOT reproduced here (silent no-op options are worse than absent ones).
    # The live tau_min belongs to the AdaptiveStep rule (src/utils.jl:24,
    # src/kernels.jl:300), mirrored by AdaptiveStep.tau_min above.
    max_iter: int = 3000
    max_wall_time: float = 1e6
    divergence_tol: float = 1e4
    #: looser tolerance for the acceptable-level exit (MadNLP machinery the
    #: reference inherits): stalling inside acceptable_tol for
    #: acceptable_iter consecutive iterations returns
    #: SOLVED_TO_ACCEPTABLE_LEVEL instead of iterating to max_iter.
    acceptable_tol: float = 1e-6
    acceptable_iter: int = 15

    # Initialization options
    scaling: bool = True
    bound_push: float = 1e-2
    bound_fac: float = 1e-2
    bound_relax_factor: float = 1e-12

    # Regularization
    regularization: object = dataclasses.field(
        default_factory=lambda: FixedRegularization(1e-10, 1e-10)
    )

    # Step
    step_rule: object = dataclasses.field(default_factory=lambda: AdaptiveStep(0.99))

    # Barrier
    barrier_update: object = dataclasses.field(default_factory=Mehrotra)
    max_ncorr: int = 0  # Gondzio multiple centrality corrections
    s_max: float = 100.0
    mu_init: float = 1e-1
    mu_min: float = 1e-12
    #: balanced-central-path safeguard: floor the barrier at
    #: ``mu_balance * max(inf_pr, inf_du)`` (scaled residuals) so mu cannot
    #: collapse orders of magnitude below feasibility — which wrecks the
    #: KKT conditioning beyond what the mixed-precision solves can handle
    #: (solver/driver._direction_phase).  Inert on healthy solves
    #: (feasibility normally leads mu); 0 disables.  No reference analogue
    #: (its fp64 direct factorizations absorb the collapse differently).
    mu_balance: float = 1e-2

    # Linear solve
    tol_linear_solve: float = 1e-8
    check_residual: bool = False
    #: inexact-Newton mode: scale each PCG exit tolerance with the current
    #: barrier parameter (predictor ~0.05*mu, corrector ~0.01*mu_new, both
    #: clamped well inside tol_linear_solve).  Early IPM iterations then stop
    #: the inner Krylov solve as soon as the step is accurate enough for the
    #: outer iteration, cutting per-iteration PCG sweeps.  Off by default —
    #: matches the reference's fixed-accuracy direct solves.
    pcg_adaptive_tol: bool = False
    #: upper clamp of the corrector's mu-adaptive PCG exit tolerance (only
    #: read when pcg_adaptive_tol=True; the PREDICTOR's clamp is fixed at
    #: 1e-8 and deliberately NOT coupled to this — loosened caps were only
    #: measured with predictor_pcg_budget=0).  The default 1e-9 makes every
    #: early/mid IPM iteration solve its corrector to 1e-9 relative even
    #: though the outer iteration only needs a residual well under mu —
    #: raising the cap trades extra IPM iterations for fewer fp64 PCG
    #: operator applications per iteration.  Measure before adopting;
    #: the late phase is unaffected either way (mu < cap/0.01 re-enters
    #: the mu-proportional regime).
    pcg_tol_cap: float = 1e-9
    #: LOWER clamp of the corrector's mu-adaptive PCG exit tolerance (only
    #: read when pcg_adaptive_tol=True).  As mu falls toward ~1e-10 the
    #: mu-proportional rule asks for relative residuals near this floor
    #: while the fp32-factor preconditioner is at its weakest, so the late
    #: corrector PCG sweeps grow.  Inexact-Newton analysis only needs step
    #: residuals ~0.01*tol relative to the (itself shrinking) rhs for 1e-8
    #: convergence; raising the floor to ~1e-10 removes the over-solve.
    #: Default keeps the historical 1e-13; measure before adopting.
    pcg_tol_floor: float = 1e-13
    #: max fp64 iterative-refinement sweeps after each low-precision
    #: factor-solve (0 disables; load-bearing for reaching tol=1e-8 with an
    #: fp32 factorization).  Only read when the factor runs below the
    #: residual precision, or for K1 CONDENSED.  The refinement loop exits
    #: early on convergence, so this is a budget, not a fixed cost
    #: (ops/linalg.refine); the corrector PCG budget is 4x this.  At 6,
    #: rhs-perturbed fp32-factor instances ground past max_iter at the
    #: barrier floor (the budget, not the tolerance rule, binds there);
    #: healthy lanes exit on rtol long before the cap.
    refinement_steps: int = 12
    #: PCG iteration budget of the PREDICTOR (affine-scaling) solve.
    #: None = max(2, refinement_steps // 2) (the default since round 1).
    #: 0 = preconditioner-only: apply the fp32 factor solve and skip the
    #: fp64 PCG entirely — no operator application, no residual check.
    #: The affine direction only shapes the centering heuristics (mu_aff,
    #: sigma, the Mehrotra correction products), which need ~2-3 digits,
    #: so a factor-accurate direction can suffice; the corrector (the
    #: actual step) always solves to full accuracy.  Saves ~2 fp64
    #: A-applications per iteration — measure solve rate before adopting.
    predictor_pcg_budget: Optional[int] = None
    #: advance the fused driver's memoized ``A x`` / ``A' y`` pair by
    #: RECURRENCE (``ax += alpha_p * A dx``, with ``A dx`` and ``A' dy``
    #: taken from corrector-solve byproducts — ops/kkt.solve_condensed
    #: ``return_products``) instead of recomputing both products at every
    #: loop trip.  Saves 2 of the ~8 fp64 A-applications per iteration on
    #: the NORMAL fp64-PCG path.  The recurrence carries O(eps64) rounding
    #: per iteration; the fused drivers resync it EXACTLY every CERT_PERIOD
    #: (=16) trips at the certificate-refresh boundary, bounding the drift
    #: at ~1e-14 relative — far below tol.  The python-driven diagnostic
    #: drivers (solve_logged/solve_timed) always recompute exactly.
    product_recurrence: bool = True

    # Compute dtype of the factorization.  None = the residual dtype
    # (fp64 factor, no refinement); "float32" selects the mixed-precision
    # route (fp32 factor + fp64 PCG refinement).
    factor_dtype: Optional[str] = None

    #: second-order preconditioner for the NORMAL low-precision-factor
    #: path: retain the unshifted Jacobi-scaled normal matrix alongside the
    #: (PRECOND_SHIFT-regularized) factor and apply one inner correction
    #: per preconditioner application, M⁻¹' b = z + M⁻¹(b − Ŝ z).  The
    #: shift floors weak-direction preconditioned eigenvalues at λ/(λ+σ),
    #: which is what forces several fp64 PCG iterations in the late IPM
    #: phase; the correction cancels that error to first order for one
    #: fp32 matvec + one extra factor application per preconditioner call.
    #: Costs one retained (m,m) fp32 buffer per lane.  The doubled
    #: preconditioner cost applies to EVERY PCG iteration of EVERY phase —
    #: including the early/mid iterations where one application already
    #: met the exit tolerance — so it only pays for workloads whose
    #: conditioning keeps the PCG deep throughout (tol ≪ 1e-8, or heavily
    #: degenerate tails).  Not measured on the GPU.
    precond_refine: bool = False

    #: XLA matmul precision for the factor-dtype work (normal assembly, the
    #: blocked factorization, preconditioner applications) when the factor
    #: runs below the residual precision: "default" (on the GPU, TF32 tensor
    #: cores), "high", "highest" (true fp32), or None = inherit the global
    #: jax default.  Reduced precision truncates the factor in an
    #: unstructured way that swamps the 1e-12-scale eigenvalues of the
    #: Jacobi-scaled normal matrix near the barrier floor (unlike the
    #: structured PRECOND_SHIFT), and the fp64 PCG budget cannot recover at
    #: tol=1e-8.  Kept for looser-tolerance workloads; leave None for
    #: tol<=1e-8.
    factor_precision: Optional[str] = None

    #: precondition the fp64 PCG with an inner fp32 CG (flexible PCG).
    #: Off by default: measured at the bench shape the fp32 factor alone
    #: already exits the PCG in 1-2 iterations, so the inner CG only adds
    #: overhead (ops/kkt.KKTConfig.use_flex_pcg).
    pcg_flex: bool = False

    #: how the dense path's fp64 A-matvecs are evaluated:
    #:   "auto"     — the exact fp64 product (``A @ x``);
    #:   "ozaki"    — error-free bf16 slicing (ops/ozaki.py): bf16 dots
    #:                with fp32 accumulation, ~2^-44 relative accuracy at
    #:                the default 7 slices;
    #:   "ozaki_i8" — int8 slices with int32 accumulation (ops/ozaki.py).
    #: The sliced variants are explicit choices only; "auto" never picks
    #: them.
    fp64_matvec: str = "auto"

    #: number of bf16 Ozaki slices per operand (None = ops/ozaki.N_SLICES
    #: = 7, ~2^-44 operator accuracy, 49 pass-pairs).  Fewer slices give a
    #: cheaper, less exact operator: the bound is ~2n*2^-(8S) relative
    #: (5 slices reach ~3.7e-9 at n=2048 and ~1.5e-8 at n=8192), so the
    #: default stays 7, which keeps the operator effectively exact for
    #: arbitrary problem sizes.
    ozaki_slices: Optional[int] = None

    #: store only the FORWARD Ozaki slices and run A'-matvecs through the
    #: transposed chunked contraction (ops/ozaki.matvec_t) — halves the
    #: slice device-memory footprint.  None = auto: share when the slice
    #: pair would exceed ~1 GB.
    ozaki_share_slices: Optional[bool] = None

    def resolved_kkt(self, is_qp: bool) -> KKTSystem:
        if self.kkt_system is not None:
            return self.kkt_system
        return KKTSystem.AUGMENTED if is_qp else KKTSystem.NORMAL

    def resolved_linear_solver(self, kkt: KKTSystem) -> LinearSolver:
        if self.linear_solver is not None:
            return self.linear_solver
        if kkt in (KKTSystem.NORMAL, KKTSystem.CONDENSED):
            return LinearSolver.CHOLESKY  # both factorize an SPD matrix
        return LinearSolver.LDL


def load_options(**kwargs) -> IPMOptions:
    """Build IPMOptions from keyword arguments, warning on unknown keys.

    Mirrors the reference two-stage option routing (src/utils.jl:121-148):
    unknown keys are reported rather than raising, so callers can pass a
    superset of options.
    """
    known = {f.name for f in dataclasses.fields(IPMOptions)}
    opts = {k: v for k, v in kwargs.items() if k in known}
    ignored = {k: v for k, v in kwargs.items() if k not in known}
    if ignored:
        import warnings

        warnings.warn(f"Ignoring unsupported options: {sorted(ignored)}")
    return IPMOptions(**opts)
