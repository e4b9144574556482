"""Mehrotra predictor-corrector driver.

Functional analogue of the reference's algorithm layer (reference:
src/solver.jl): initialization (Mehrotra starting point), the MPC hot loop
(factorize -> predictor -> Mehrotra corrector -> Gondzio corrections -> step
rule -> apply), and termination/infeasibility/divergence detection.

Two execution modes:
- :func:`solve_device` — the whole solve is ONE jitted XLA program
  (``lax.while_loop`` over :func:`iteration`); status/termination scalars
  stay on device.  This is the benchmark path.
- :func:`solve_logged` — per-iteration jit with a Python loop, enabling the
  reference-style iteration log (src/structure.jl:180-197) and wall-time
  checks (src/solver.jl:216).
"""

from __future__ import annotations

import dataclasses
import time
from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ..models.qp import DeviceQP
from ..ops import kkt as kkt_ops
from ..ops.kkt import KKTConfig
from ..utils.options import (
    AdaptiveRegularization,
    AdaptiveStep,
    ConservativeStep,
    FixedRegularization,
    IPMOptions,
    KKTSystem,
    MehrotraAdaptiveStep,
    NoRegularization,
    StepRuleKind,
)
from ..utils.status import Status
from . import kernels as K
from .state import IPMState, init_state


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Static (trace-time) solver configuration derived from IPMOptions."""

    kkt: KKTConfig
    tol: float
    acceptable_tol: float
    acceptable_iter: int
    max_iter: int
    divergence_tol: float
    mu_init: float
    mu_min: float
    max_ncorr: int
    s_max: float
    scaling: bool
    bound_push: float
    bound_fac: float
    bound_relax_factor: float
    step_rule: object
    regularization: object
    #: Mehrotra barrier-update strategy instance (sigma clamp/power;
    #: reference update_barrier! dispatch, src/solver.jl:235).
    barrier_update: object
    check_residual: bool
    tol_linear_solve: float
    pcg_adaptive_tol: bool = False
    #: upper clamp for the corrector's mu-adaptive PCG rtol (the predictor
    #: clamp is fixed at 1e-8; see IPMOptions.pcg_tol_cap).
    pcg_tol_cap: float = 1e-9
    #: lower clamp of the same tolerance (see IPMOptions.pcg_tol_floor —
    #: the round-5 late-phase over-solve lever).
    pcg_tol_floor: float = 1e-13
    #: balanced-central-path coefficient (see _direction_phase); 0 disables.
    mu_balance: float = 1e-2
    #: evaluate fp64 A-matvecs via the error-free Ozaki slicing
    #: (ops/ozaki.py) instead of the exact fp64 product; resolved from
    #: IPMOptions.fp64_matvec.
    use_ozaki: bool = False
    #: "bf16" (7 bf16 slices, fp32 accumulation) or "i8" (8 int8 slices,
    #: int32 accumulation) — see ops/ozaki.py module notes.
    ozaki_variant: str = "bf16"
    #: None = auto (share the forward slices for A'-matvecs when the slice
    #: pair would exceed ~1 GB); see IPMOptions.ozaki_share_slices.
    ozaki_share_slices: Optional[bool] = None
    #: bf16 slices per Ozaki operand (None = ozaki.N_SLICES); see
    #: IPMOptions.ozaki_slices.
    ozaki_slices: Optional[int] = None
    #: predictor PCG budget; None = max(2, refinement_steps // 2); 0 =
    #: preconditioner-only affine solve (see IPMOptions.predictor_pcg_budget).
    predictor_pcg_budget: Optional[int] = None
    #: advance the memoized A x / A' y termination pair by recurrence from
    #: corrector-solve byproducts instead of recomputing it every loop trip
    #: (see IPMOptions.product_recurrence); exact resync every CERT_PERIOD.
    product_recurrence: bool = True


def make_config(
    opt: IPMOptions, is_qp: bool, dtype=jnp.float64,
    mesh=None, dist_axis: str = "cols",
) -> SolverConfig:
    """``mesh`` (a jax.sharding.Mesh) routes the NORMAL-path factorization
    through the distributed strip Cholesky (parallel/dist_chol.py): the
    m x m normal matrix is reduce-scattered and panel-factored across the
    mesh axis ``dist_axis`` instead of replicated."""
    kind = opt.resolved_kkt(is_qp)
    if kind == KKTSystem.NORMAL and is_qp:
        raise ValueError(
            "NormalKKT supports only linear programs (reference: "
            "src/KKT/normalkkt.jl:45-48); use kkt_system=AUGMENTED for QPs."
        )
    if mesh is not None and kind not in (KKTSystem.NORMAL, KKTSystem.CONDENSED):
        raise ValueError(
            f"the distributed factorization supports the NORMAL (LP) and "
            f"CONDENSED (QP) KKT systems, got {kind} "
            f"(use kkt_system=NORMAL/CONDENSED or mesh=None)"
        )
    factor_dtype = jnp.dtype(opt.factor_dtype) if opt.factor_dtype else jnp.dtype(dtype)
    # Refinement sweeps only pay off when the factor runs below the residual
    # precision (fp32 factor + fp64 residuals); same-precision factors skip
    # it — except K1 CONDENSED, whose gamma-relaxation (cond(C) ~ 1e8) needs
    # the PCG polish even with an fp64 factor.
    if factor_dtype != jnp.dtype(dtype) or kind == KKTSystem.CONDENSED:
        refinement = opt.refinement_steps
    else:
        refinement = 0
    kcfg = KKTConfig(
        kind=kind,
        linear_solver=opt.resolved_linear_solver(kind),
        factor_dtype=factor_dtype,
        refinement_steps=refinement,
        max_factor_trials=3,
        use_flex_pcg=opt.pcg_flex,
        dist_mesh=mesh,
        dist_axis=dist_axis,
        factor_precision=opt.factor_precision,
        precond_refine=opt.precond_refine,
    )
    from ..utils.options import Mehrotra

    barrier = opt.barrier_update
    if not isinstance(barrier, Mehrotra):
        raise ValueError(
            f"barrier_update must be a Mehrotra instance, got {barrier!r} "
            "(the only strategy the reference implements, src/utils.jl:10-11)"
        )
    ozaki_variant = "bf16"
    if opt.fp64_matvec == "auto":
        use_ozaki = False
    elif opt.fp64_matvec == "ozaki":
        use_ozaki = jnp.dtype(dtype) == jnp.float64
    elif opt.fp64_matvec == "ozaki_i8":
        use_ozaki = jnp.dtype(dtype) == jnp.float64
        ozaki_variant = "i8"
    else:
        raise ValueError(
            "fp64_matvec must be 'auto' (the exact fp64 product), 'ozaki' or "
            f"'ozaki_i8', got {opt.fp64_matvec!r}"
        )
    return SolverConfig(
        kkt=kcfg,
        tol=opt.tol,
        acceptable_tol=opt.acceptable_tol,
        acceptable_iter=opt.acceptable_iter,
        max_iter=opt.max_iter,
        divergence_tol=opt.divergence_tol,
        mu_init=opt.mu_init,
        mu_min=opt.mu_min,
        max_ncorr=opt.max_ncorr,
        s_max=opt.s_max,
        scaling=opt.scaling,
        bound_push=opt.bound_push,
        bound_fac=opt.bound_fac,
        bound_relax_factor=opt.bound_relax_factor,
        step_rule=opt.step_rule,
        regularization=opt.regularization,
        barrier_update=barrier,
        check_residual=opt.check_residual,
        tol_linear_solve=opt.tol_linear_solve,
        pcg_adaptive_tol=opt.pcg_adaptive_tol,
        pcg_tol_cap=opt.pcg_tol_cap,
        pcg_tol_floor=opt.pcg_tol_floor,
        mu_balance=opt.mu_balance,
        use_ozaki=use_ozaki,
        ozaki_variant=ozaki_variant,
        ozaki_slices=opt.ozaki_slices,
        ozaki_share_slices=opt.ozaki_share_slices,
        predictor_pcg_budget=opt.predictor_pcg_budget,
        product_recurrence=opt.product_recurrence,
    )


# ---------------------------------------------------------------------------
# Scaling (MadNLP.set_scaling! analogue; reference src/solver.jl:148-159)
# ---------------------------------------------------------------------------


class ScaleInfo(NamedTuple):
    """Row/objective scaling factors applied to the device problem."""

    obj_scale: jax.Array
    con_scale: jax.Array


def _apply_scaling(cfg: SolverConfig, prob: DeviceQP, x_init):
    """Max-norm row scaling capped at s_max (MadNLP set_scaling! semantics:
    scale = min(1, s_max / ||row||_inf)); objective likewise."""
    one = jnp.asarray(1.0, prob.dtype)
    if cfg.scaling:
        row_norm = prob.row_inf_norm()
        con_scale = jnp.where(
            prob.row_mask, jnp.minimum(one, cfg.s_max / jnp.maximum(row_norm, 1e-30)), one
        )
        g0 = K.eval_grad(prob, x_init)
        gnorm = jnp.max(jnp.where(prob.free_mask, jnp.abs(g0), 0.0))
        obj_scale = jnp.minimum(one, cfg.s_max / jnp.maximum(gnorm, 1e-30))
    else:
        con_scale = jnp.ones_like(prob.b)
        obj_scale = one
    prob_s = dataclasses.replace(
        prob.scale_rows(con_scale).scale_quad(obj_scale),
        b=prob.b * con_scale,
        c=prob.c * obj_scale,
        c0=prob.c0 * obj_scale,
    )
    return prob_s, ScaleInfo(obj_scale, con_scale)


# ---------------------------------------------------------------------------
# Regularization policies (reference src/kernels.jl:360-401)
# ---------------------------------------------------------------------------


def _init_regularization(cfg: SolverConfig, dtype):
    reg = cfg.regularization
    one = jnp.asarray(1.0, dtype)
    if isinstance(reg, NoRegularization):
        return one, jnp.asarray(0.0, dtype), jnp.asarray(0.0, dtype), jnp.asarray(0.0, dtype)
    if isinstance(reg, FixedRegularization):
        return one, jnp.asarray(reg.delta_d, dtype), jnp.asarray(reg.delta_p, dtype), jnp.asarray(reg.delta_d, dtype)
    if isinstance(reg, AdaptiveRegularization):
        return one, jnp.asarray(reg.delta_d, dtype), jnp.asarray(reg.delta_p, dtype), jnp.asarray(reg.delta_d, dtype)
    raise TypeError(f"unknown regularization {reg!r}")


def _update_regularization(cfg: SolverConfig, state: IPMState):
    reg = cfg.regularization
    zero = jnp.zeros_like(state.del_w)
    if isinstance(reg, NoRegularization):
        return zero, zero, state.reg_p, state.reg_d
    if isinstance(reg, FixedRegularization):
        return (
            jnp.asarray(reg.delta_p, state.del_w.dtype),
            jnp.asarray(reg.delta_d, state.del_w.dtype),
            state.reg_p,
            state.reg_d,
        )
    if isinstance(reg, AdaptiveRegularization):
        reg_p = jnp.maximum(state.reg_p / 10.0, reg.delta_min)
        reg_d = jnp.minimum(state.reg_d / 10.0, -reg.delta_min)
        return reg_p, reg_d, reg_p, reg_d
    raise TypeError(f"unknown regularization {reg!r}")


# ---------------------------------------------------------------------------
# Initialization (reference initialize! + init_starting_point!,
# src/solver.jl:1-189)
# ---------------------------------------------------------------------------


def initialize(cfg: SolverConfig, prob: DeviceQP) -> Tuple[DeviceQP, "ScaleInfo", IPMState]:
    dtype = prob.dtype
    n, m = prob.n, prob.m
    free = prob.free_mask

    # --- Bound relaxation (MadNLP.initialize! tol=bound_relax_factor)
    brf = cfg.bound_relax_factor
    lb = jnp.where(
        free & jnp.isfinite(prob.lb),
        prob.lb - brf * jnp.maximum(1.0, jnp.abs(prob.lb)),
        prob.lb,
    )
    ub = jnp.where(
        free & jnp.isfinite(prob.ub),
        prob.ub + brf * jnp.maximum(1.0, jnp.abs(prob.ub)),
        prob.ub,
    )
    prob = dataclasses.replace(prob, lb=lb, ub=ub)

    # --- Push x0 strictly inside its bounds (Ipopt-style projection with
    # kappa1=bound_push, kappa2=bound_fac; MadNLP.initialize!)
    k1, k2 = cfg.bound_push, cfg.bound_fac
    width = ub - lb
    pl = jnp.minimum(k1 * jnp.maximum(1.0, jnp.abs(lb)), k2 * width)
    pu = jnp.minimum(k1 * jnp.maximum(1.0, jnp.abs(ub)), k2 * width)
    x = prob.x0
    x = jnp.where(free & jnp.isfinite(lb), jnp.maximum(x, lb + pl), x)
    x = jnp.where(free & jnp.isfinite(ub), jnp.minimum(x, ub - pu), x)
    # Fixed/padded columns pinned to their (lower) bound value.
    x = jnp.where(free, x, jnp.where(prob.col_mask, prob.lb, 0.0))
    y = prob.y0

    # --- Scaling (reference src/solver.jl:148-159)
    prob_s, scale = _apply_scaling(cfg, prob, x)

    # --- Ozaki slicing of the (scaled) Jacobian: from here on every fp64
    # A-matvec runs as error-free sliced low-precision dots (ops/ozaki.py).
    # Built once per solve, after scaling (slices snapshot A's values).
    # The SPARSE path (SparseDeviceQP, no with_ozaki) keeps the plain fp64
    # SpMV: its ELL matvec is gather-bound, and a slice-pair scheme (49
    # gather passes) would multiply the gathers.
    if cfg.use_ozaki and hasattr(prob_s, "with_ozaki"):
        share = cfg.ozaki_share_slices
        if share is None:
            # Auto: keep the (slightly faster) stored transpose while the
            # slice pair is cheap; share the forward slices once the pair
            # would exceed ~1 GB of device memory.
            m_, n_ = prob_s.A.shape
            pair_bytes = 2 * 7 * 2 * m_ * n_  # two copies x S=7 x bf16
            share = pair_bytes > 1 << 30
        prob_s = prob_s.with_ozaki(
            cfg.ozaki_variant, share_slices=share, n_slices=cfg.ozaki_slices
        )

    # --- Initial regularization + gradient/norms
    del_w, del_c, reg_p, reg_d = _init_regularization(cfg, dtype)
    g0 = K.eval_grad(prob_s, x)
    norm_b = jnp.max(jnp.where(prob_s.row_mask, jnp.abs(prob_s.b), 0.0))
    norm_c = jnp.max(jnp.where(prob_s.free_mask, jnp.abs(g0), 0.0))

    # --- Initial KKT factorization with Sigma = del_w (zl = zu = 0)
    zeros_n = jnp.zeros(n, dtype)
    factors, del_w, del_c, _ok = kkt_ops.factorize(
        cfg.kkt, prob_s, x, zeros_n, zeros_n, del_w, del_c
    )

    # --- Step 1: x <- x + dx, dx least-squares solution of A dx = b - A x
    rp = -K.eval_cons_residual(prob_s, x)
    dx, _ = kkt_ops.solve_condensed(cfg.kkt, prob_s, factors, jnp.zeros(n, dtype), rp)
    x = x + dx

    # --- Step 2: y = least-squares solution of A' y = -grad
    rx = jnp.where(prob_s.free_mask, -g0, 0.0)
    _, dy = kkt_ops.solve_condensed(cfg.kkt, prob_s, factors, rx, jnp.zeros(m, dtype))
    y = dy

    # --- Step 3: bound multipliers from res = grad + A'y
    res = g0 + K.eval_jty(prob_s, y)
    both = jnp.isfinite(lb) & jnp.isfinite(ub)
    zl = jnp.where(both, 0.5 * res, jnp.where(jnp.isfinite(lb), res, 0.0))
    zu = jnp.where(both, -0.5 * res, jnp.where(jnp.isfinite(ub), -res, 0.0))
    zl = jnp.where(prob.has_lb, zl, 0.0)
    zu = jnp.where(prob.has_ub, zu, 0.0)

    # --- Interiority shifts (reference src/solver.jl:68-99)
    has_lb, has_ub = prob.has_lb, prob.has_ub
    sl = jnp.where(has_lb, x - lb, jnp.inf)
    su = jnp.where(has_ub, ub - x, jnp.inf)
    min0 = lambda v: jnp.minimum(0.0, jnp.min(v))
    delta_x = jnp.maximum(0.0, jnp.maximum(-1.5 * min0(sl), -1.5 * min0(su)))
    delta_s = jnp.maximum(
        0.0,
        jnp.maximum(
            -1.5 * min0(jnp.where(has_lb, zl, jnp.inf)),
            -1.5 * min0(jnp.where(has_ub, zu, jnp.inf)),
        ),
    )
    # x_lr += delta_x then x_ur -= delta_x: entries with both bounds cancel
    # (the reference applies the shifts through overlapping views,
    # src/solver.jl:80-81).
    shift = delta_x * (has_lb.astype(dtype) - has_ub.astype(dtype))
    x = x + shift
    zl = jnp.where(has_lb, zl + 1.0 + delta_s, 0.0)
    zu = jnp.where(has_ub, zu + 1.0 + delta_s, 0.0)

    sl = jnp.where(has_lb, x - lb, 0.0)
    su = jnp.where(has_ub, ub - x, 0.0)
    mu_sum = jnp.sum(sl * zl) + jnp.sum(su * zu)
    nz = jnp.sum(jnp.where(has_lb, zl, 0.0)) + jnp.sum(jnp.where(has_ub, zu, 0.0))
    nsl = jnp.sum(sl) + jnp.sum(su)
    # Guard the no-bounds case: the reference's 0/0 here lands on empty
    # views and is a no-op (src/solver.jl:93-99); with masks a NaN*0 would
    # poison x, so produce an explicit 0 shift instead.
    delta_x2 = jnp.where(nz > 0, mu_sum / (2.0 * nz), 0.0)
    delta_s2 = jnp.where(nsl > 0, mu_sum / (2.0 * nsl), 0.0)
    x = x + delta_x2 * (has_lb.astype(dtype) - has_ub.astype(dtype))
    zl = jnp.where(has_lb, zl + delta_s2, 0.0)
    zu = jnp.where(has_ub, zu + delta_s2, 0.0)

    # --- Ipopt projection heuristic back into [l, u]
    # (reference src/solver.jl:101-118; note max(1, l) — not |l| — verbatim)
    kappa = cfg.bound_fac
    pl = jnp.minimum(kappa * jnp.maximum(1.0, lb), kappa * (ub - lb))
    pu = jnp.minimum(kappa * jnp.maximum(1.0, ub), kappa * (ub - lb))
    x_proj = jnp.where(x < lb, lb + pl, jnp.where(ub < x, ub - pu, x))
    x = jnp.where(free, x_proj, x)

    st = init_state(n, m, dtype)
    st = st._replace(
        x=x, y=y, zl=zl, zu=zu, lb=lb, ub=ub,
        mu=jnp.asarray(cfg.mu_init, dtype),
        del_w=del_w, del_c=del_c, reg_p=reg_p, reg_d=reg_d,
        obj_val=K.eval_obj(prob_s, x),
        norm_b=norm_b, norm_c=norm_c,
        status=jnp.asarray(int(Status.REGULAR), jnp.int32),
    )
    return prob_s, scale, st


# ---------------------------------------------------------------------------
# Termination (reference update_termination_criteria!, src/solver.jl:194-222)
# ---------------------------------------------------------------------------


def update_termination(
    cfg: SolverConfig, prob: DeviceQP, state: IPMState, ax=None, aty=None
) -> IPMState:
    prob = dataclasses.replace(prob, lb=state.lb, ub=state.ub)
    x, y, zl, zu = state.x, state.y, state.zl, state.zu
    obj = K.eval_obj(prob, x)
    dobj = K.dual_objective(prob, y, zl, zu)
    inf_pr = K.primal_infeasibility(prob, x, ax) / jnp.maximum(1.0, state.norm_b)
    inf_du = K.dual_infeasibility(prob, x, y, zl, zu, aty) / jnp.maximum(
        1.0, state.norm_c
    )
    inf_compl = K.complementarity_inf(prob, x, zl, zu) / jnp.maximum(1.0, state.norm_c)
    best = jnp.minimum(state.best_compl, inf_compl)

    res_max = jnp.maximum(jnp.maximum(inf_pr, inf_du), inf_compl)
    converged = res_max <= cfg.tol
    # Acceptable-level exit (MadNLP semantics the reference inherits:
    # acceptable_tol/acceptable_iter — stalling inside the looser tolerance
    # for several consecutive iterations exits SOLVED_TO_ACCEPTABLE_LEVEL
    # instead of burning the full iteration budget; fp32-factored solves at
    # large scale hit their attainable floor this way).
    in_acc = res_max <= cfg.acceptable_tol
    n_acc = jnp.where(in_acc, state.n_acceptable + 1, 0).astype(jnp.int32)
    acceptable = in_acc & (n_acc >= cfg.acceptable_iter)
    infeasible = (inf_compl > cfg.divergence_tol * best) & (
        dobj > jnp.maximum(10.0 * jnp.abs(obj), 1.0)
    )
    # Infeasibility by primal stall: the iteration has converged in the
    # dual and complementarity senses but the primal residual is stuck FAR
    # from zero — the least-squares limit point the MPC converges to on an
    # infeasible LP is exactly such a point (no Farkas ray needed).  The
    # 1e-4-ish sqrt(tol) floor on inf_pr keeps numerically-grinding but
    # FEASIBLE instances (which stall around ~1e-5) out of this branch; they exit via
    # acceptable/max_iter instead.  The reference's detector (compl
    # divergence + dual blowup, src/solver.jl:209-213) stays as-is above —
    # this catches the complementary case where nothing diverges.
    improved = inf_pr < 0.99 * state.best_pr
    best_pr = jnp.minimum(state.best_pr, inf_pr)
    n_stall = jnp.where(improved, 0, state.n_stall + 1).astype(jnp.int32)
    compl_floor = jnp.maximum(cfg.acceptable_tol, 10.0 * cfg.mu_balance * inf_pr)
    # state.ls_cert: the stalled point must additionally be a (periodically
    # re-evaluated) least-squares stationarity certificate — without it, a
    # FEASIBLE instance whose inf_pr is pinned at ~1e-4 by linear-solve
    # noise matches every other gate here and gets misclassified (observed
    # on a rhs-perturbed bench instance; the certificate is exact on true LS limit points and O(1)-violated at
    # noise stalls — kernels.ls_infeasibility_certificate).
    stall_infeasible = (
        (n_stall >= 100)
        & (inf_pr > jnp.sqrt(cfg.tol))
        & (inf_du <= cfg.acceptable_tol)
        & (inf_compl <= compl_floor)
        & state.ls_cert
    )
    infeasible = infeasible | stall_infeasible
    diverging = obj < -cfg.divergence_tol * jnp.maximum(
        10.0, jnp.maximum(jnp.abs(dobj), 1.0)
    )
    max_iter = state.k >= cfg.max_iter

    status = jnp.where(
        converged,
        int(Status.SOLVE_SUCCEEDED),
        jnp.where(
            acceptable,
            int(Status.SOLVED_TO_ACCEPTABLE_LEVEL),
            jnp.where(
                infeasible,
                int(Status.INFEASIBLE_PROBLEM_DETECTED),
                jnp.where(
                    diverging,
                    int(Status.DIVERGING_ITERATES),
                    jnp.where(
                        max_iter, int(Status.MAXIMUM_ITERATIONS_EXCEEDED), state.status
                    ),
                ),
            ),
        ),
    ).astype(jnp.int32)
    return state._replace(
        obj_val=obj, inf_pr=inf_pr, inf_du=inf_du, inf_compl=inf_compl,
        best_compl=best, status=status, n_acceptable=n_acc,
        best_pr=best_pr, n_stall=n_stall,
    )


# ---------------------------------------------------------------------------
# One MPC iteration (reference mpc! loop body, src/solver.jl:332-360)
# ---------------------------------------------------------------------------


def _factor_phase(cfg: SolverConfig, prob: DeviceQP, state: IPMState, active=None):
    """Regularization update + KKT factorization (reference
    factorize_system!, src/solver.jl:299-303).  Split out so the timed
    driver (solve_timed) can account it as linear-solver work the way the
    reference's counters do (MadNLPCounters.linear_solver_time,
    scripts/benchmarks_cpu.jl:50).

    ``active`` (traced bool, per-lane under vmap) enables finished-lane
    neutralization: a non-REGULAR lane executes the factorization anyway
    (vmap select-masks, it cannot skip), so it gets a BENIGN system —
    zl = zu = 0 and del_w = 1 pin Sigma to exactly 1, and ``force_ok``
    disarms the x100 retry loop — instead of its terminal barrier system
    (Sigma spanning ~16 decades), whose fp32 factorization failures would
    drive up to max_factor_trials extra factorizations for ALL lanes on
    every remaining trip.
    """
    prob = dataclasses.replace(prob, lb=state.lb, ub=state.ub)
    del_w, del_c, reg_p, reg_d = _update_regularization(cfg, state)
    zl, zu = state.zl, state.zu
    force_ok = None
    if active is not None:
        zero = jnp.zeros_like(zl)
        zl = jnp.where(active, zl, zero)
        zu = jnp.where(active, zu, zero)
        del_w = jnp.where(active, del_w, jnp.ones_like(del_w))
        del_c = jnp.where(active, del_c, jnp.zeros_like(del_c))
        force_ok = ~active
    factors, del_w, del_c, _ok = kkt_ops.factorize(
        cfg.kkt, prob, state.x, zl, zu, del_w, del_c, force_ok=force_ok
    )
    return factors, del_w, del_c, reg_p, reg_d


def _direction_phase(
    cfg: SolverConfig, prob: DeviceQP, state: IPMState,
    factors, ax, aty, active=None, rhs_aff=None, return_products=False,
):
    """Predictor + Mehrotra corrector (+ Gondzio) KKT solves.  Returns the
    accepted direction and the new barrier parameter; solve-dominated (the
    RHS builds in here are elementwise O(n) glue given the precomputed
    ax/aty pair — no A-applications outside the solves).

    ``return_products=True`` appends ``(A dx, A' dy)`` of the ACCEPTED
    direction (Gondzio-corrected if accepted) to the return tuple, taken
    from solve byproducts — the fused driver's A x / A' y recurrence.

    ``active`` (see _factor_phase): a non-REGULAR lane's solve rhs is
    zeroed, so every PCG exits on its first residual check (r0 = 0) instead
    of grinding its full iteration budget on the lane's terminal barrier
    system — under vmap the PCG while_loop trip count is the max over
    lanes, so one finished lane would otherwise slow every active lane."""
    prob = dataclasses.replace(prob, lb=state.lb, ub=state.ub)
    x, y, zl, zu = state.x, state.y, state.zl, state.zu

    _solve = partial(kkt_ops.solve_condensed, cfg.kkt, prob, factors)
    if active is None:
        solve = _solve
    else:
        def solve(rx, rp, **kw):
            return _solve(
                jnp.where(active, rx, jnp.zeros_like(rx)),
                jnp.where(active, rp, jnp.zeros_like(rp)),
                **kw,
            )

    # Inexact-Newton tolerances: early iterations tolerate step residuals
    # proportional to the complementarity (standard inexact-MPC analysis);
    # clamped well below the reference's tol_linear_solve=1e-8 acceptance
    # threshold (src/linear_solver.jl:28-43).  Off -> fixed tight defaults.
    rtol_pred = rtol_corr = None
    if cfg.pcg_adaptive_tol:
        # The predictor clamp is FIXED at its historical 1e-8, decoupled
        # from pcg_tol_cap: every loosened-cap measurement ran with
        # predictor_pcg_budget=0 (the rtol unused), so a coupled clamp
        # would silently move a live predictor PCG (e.g. the K1 path,
        # where its polish is load-bearing) into an unmeasured regime
        # (round-3 advisor).
        rtol_pred = jnp.clip(0.05 * state.mu, 1e-11, 1e-8)

    # Predictor (reference prediction_step!, src/solver.jl:230-237).
    # The affine direction only shapes the centering heuristics, so it gets
    # a reduced PCG budget; the corrector (the actual step) solves to full
    # accuracy.  ``rhs_aff`` may be precomputed by the caller (solve_timed
    # builds it in its eval phase so linear_solver_time matches the
    # reference's factorize+solve counter semantics,
    # src/linear_solver.jl:6-44).
    if rhs_aff is None:
        rhs_aff = K.predictor_rhs(prob, x, y, zl, zu, ax, aty)
    pred_budget = (
        cfg.predictor_pcg_budget
        if cfg.predictor_pcg_budget is not None
        else max(2, cfg.kkt.refinement_steps // 2)
    )
    dx, dy = solve(
        rhs_aff.rx, rhs_aff.rp,
        pcg_budget=pred_budget,
        pcg_rtol=rtol_pred,
    )
    dzl, dzu = K.recover_bound_duals(prob, x, zl, zu, rhs_aff, dx)

    a_aff_p, a_aff_d = K.fraction_to_boundary(prob, x, zl, zu, dx, dzl, dzu, 1.0)
    mu_aff = K.affine_complementarity_measure(
        prob, x, zl, zu, dx, dzl, dzu, a_aff_p, a_aff_d
    )
    corr_l, corr_u = K.mehrotra_correction(prob, dx, dzl, dzu)
    bu = cfg.barrier_update
    mu_new, mu_curr = K.mehrotra_barrier(
        prob, x, zl, zu, mu_aff, cfg.mu_min,
        power=bu.power, sigma_min=bu.sigma_min, sigma_max=bu.sigma_max,
    )
    # Balanced central path: floor the barrier at mu_balance x the scaled
    # infeasibility (state.inf_pr/inf_du are current — update_termination
    # runs on this iterate before the step).  Without it, Mehrotra can
    # drive mu to mu_min while feasibility is still ~1e-5 (seen on a
    # perturbed bench instance); Sigma then spans
    # ~24 decades, the normal system's conditioning collapses past fp64,
    # and PCG steps turn to noise — inf_pr stalls forever.  Keeping
    # mu >= 1e-2 x residual keeps the Newton systems solvable until
    # feasibility catches up (it normally LEADS mu, so the floor is inert
    # on healthy solves).  The reference has no such guard: its fp64
    # direct factorizations tolerate the collapse better, and its
    # benchmark protocol accepts the occasional grind-to-max_iter.
    if cfg.mu_balance > 0:
        res_bal = jnp.maximum(state.inf_pr, state.inf_du)
        # inf_pr/inf_du initialize to +inf; a state stepped without a prior
        # update_termination pass (checkpoint resume, raw iteration calls)
        # must not blow mu up — no floor until residuals are measured.
        floor = jnp.where(
            jnp.isfinite(res_bal), cfg.mu_balance * res_bal, 0.0
        )
        mu_new = jnp.maximum(mu_new, floor)

    # Mehrotra corrector (reference mehrotra_correction_direction!)
    if cfg.pcg_adaptive_tol:
        rtol_corr = jnp.clip(0.01 * mu_new, cfg.pcg_tol_floor, cfg.pcg_tol_cap)
    rhs_c = K.corrector_rhs(prob, x, y, zl, zu, mu_new, corr_l, corr_u, ax, aty)
    adx = atdy = None
    if return_products:
        dx, dy, adx, atdy = solve(
            rhs_c.rx, rhs_c.rp, pcg_rtol=rtol_corr, return_products=True
        )
    else:
        dx, dy = solve(rhs_c.rx, rhs_c.rp, pcg_rtol=rtol_corr)
    dzl, dzu = K.recover_bound_duals(prob, x, zl, zu, rhs_c, dx)

    # Optional linear-solve residual guardrail (reference solve_system!
    # residual check + SolveException, src/linear_solver.jl:28-43).
    solve_bad = jnp.asarray(False)
    if cfg.check_residual:
        res = kkt_ops.solve_residual(prob, factors, rhs_c.rx, rhs_c.rp, dx, dy)
        solve_bad = res > cfg.tol_linear_solve

    # Gondzio multiple centrality corrections (reference
    # gondzio_correction_direction!, src/solver.jl:245-298), statically
    # unrolled with a carried stop flag.
    if cfg.max_ncorr > 0:
        delta, gamma = 0.1, 0.1
        beta_min, beta_max = 0.1, 10.0
        tau_g = 0.995
        alpha_p_g, alpha_d_g = K.fraction_to_boundary(
            prob, x, zl, zu, dx, dzl, dzu, tau_g
        )
        stopped = jnp.asarray(False)
        for _ in range(cfg.max_ncorr):
            t_ap = jnp.minimum(alpha_p_g + delta, 1.0)
            t_ad = jnp.minimum(alpha_d_g + delta, 1.0)
            ga = K.affine_complementarity_measure(
                prob, x, zl, zu, dx, dzl, dzu, t_ap, t_ad
            )
            mu_g = (ga / mu_curr) ** 2 * ga  # Eq. (12)
            corr_l2, corr_u2 = K.gondzio_extra_correction(
                prob, x, zl, zu, dx, dzl, dzu, corr_l, corr_u,
                t_ap, t_ad, beta_min, beta_max, mu_g,
            )
            rhs_g = K.corrector_rhs(
                prob, x, y, zl, zu, mu_g, corr_l2, corr_u2, ax, aty
            )
            adx2 = atdy2 = None
            if return_products:
                dx2, dy2, adx2, atdy2 = solve(
                    rhs_g.rx, rhs_g.rp, pcg_rtol=rtol_corr,
                    return_products=True,
                )
            else:
                dx2, dy2 = solve(rhs_g.rx, rhs_g.rp, pcg_rtol=rtol_corr)
            dzl2, dzu2 = K.recover_bound_duals(prob, x, zl, zu, rhs_g, dx2)
            hat_ap, hat_ad = K.fraction_to_boundary(
                prob, x, zl, zu, dx2, dzl2, dzu2, tau_g
            )
            # Reject when step sizes fail to grow (reference criterion,
            # src/solver.jl:288) or the extra solve produced non-finite
            # values (NaN alphas would otherwise compare False and slip
            # through the reference's `<` test).
            finite = (
                jnp.all(jnp.isfinite(dx2))
                & jnp.all(jnp.isfinite(dy2))
                & jnp.isfinite(hat_ap)
                & jnp.isfinite(hat_ad)
            )
            reject = (
                (hat_ap < 1.005 * alpha_p_g)
                | (hat_ad < 1.005 * alpha_d_g)
                | ~finite
            )
            accept = (~stopped) & (~reject)
            dx = jnp.where(accept, dx2, dx)
            dy = jnp.where(accept, dy2, dy)
            dzl = jnp.where(accept, dzl2, dzl)
            dzu = jnp.where(accept, dzu2, dzu)
            if return_products:
                adx = jnp.where(accept, adx2, adx)
                atdy = jnp.where(accept, atdy2, atdy)
            corr_l = jnp.where(accept, corr_l2, corr_l)
            corr_u = jnp.where(accept, corr_u2, corr_u)
            alpha_p_g = jnp.where(accept, hat_ap, alpha_p_g)
            alpha_d_g = jnp.where(accept, hat_ad, alpha_d_g)
            stopped = stopped | reject

    if return_products:
        return dx, dy, dzl, dzu, mu_new, mu_curr, solve_bad, adx, atdy
    return dx, dy, dzl, dzu, mu_new, mu_curr, solve_bad


def _step_phase(
    cfg: SolverConfig, prob: DeviceQP, state: IPMState,
    dx, dy, dzl, dzu, mu_new, mu_curr, solve_bad,
    del_w, del_c, reg_p, reg_d, products=None,
) -> IPMState:
    """Step rule + apply step + failure/salvage mapping (reference
    update_step_size!/apply_step!, src/solver.jl:352-358).

    ``products=(ax, aty, adx, atdy)`` switches on the A x / A' y
    recurrence: the return becomes ``(state, ax_new, aty_new)`` with
    ``ax_new = ax + alpha_p * A dx`` (and likewise the dual pair), subject
    to the same salvage/failure masking as the iterate itself — a salvaged
    lane keeps its old pair (old x), a failed lane's pair is poisoned to
    NaN so a later termination check cannot claim convergence from a
    finite-but-fictitious residual over a NaN iterate."""
    prob = dataclasses.replace(prob, lb=state.lb, ub=state.ub)
    x, y, zl, zu = state.x, state.y, state.zl, state.zu

    # Step rule (reference update_step_size!, src/kernels.jl:291-358)
    rule = cfg.step_rule
    if isinstance(rule, ConservativeStep):
        alpha_p, alpha_d = K.fraction_to_boundary(
            prob, x, zl, zu, dx, dzl, dzu, rule.tau
        )
    elif isinstance(rule, AdaptiveStep):
        tau = jnp.maximum(1.0 - mu_new, rule.tau_min)
        alpha_p, alpha_d = K.fraction_to_boundary(
            prob, x, zl, zu, dx, dzl, dzu, tau
        )
    elif isinstance(rule, MehrotraAdaptiveStep):
        alpha_p, alpha_d = K.mehrotra_adaptive_step(
            prob, x, zl, zu, dx, dzl, dzu, rule.gamma_f
        )
    else:
        raise TypeError(f"unknown step rule {rule!r}")

    # Apply step (reference apply_step!, src/solver.jl:308-317)
    x = x + alpha_p * dx
    y = y + alpha_d * dy
    zl = jnp.where(prob.has_lb, zl + alpha_d * dzl, 0.0)
    zu = jnp.where(prob.has_ub, zu + alpha_d * dzu, 0.0)

    # Nudge bounds away from numerically-touched iterates
    # (MadNLP.adjust_boundary!, reference src/solver.jl:313).
    lb_new, ub_new = K.adjust_boundary(prob, x, mu_new)

    # Numerical-failure detection: NaN anywhere in the new iterate maps to
    # ERROR_IN_STEP_COMPUTATION (reference solve_system! NaN check +
    # exception mapping, src/linear_solver.jl:40-42, src/solver.jl:396-397).
    bad = solve_bad | ~(
        jnp.all(jnp.isfinite(x))
        & jnp.all(jnp.isfinite(y))
        & jnp.all(jnp.isfinite(zl))
        & jnp.all(jnp.isfinite(zu))
    )
    # Graceful degradation: a failed step on an iterate that already meets
    # the acceptable tolerance (update_termination ran on it this trip)
    # exits SOLVED_TO_ACCEPTABLE_LEVEL on the PREVIOUS iterate instead of
    # erroring — the fp32-factored PCG hitting its attainable floor a few
    # bits above tol is convergence, not failure.  (The reference has no
    # equivalent: its SolveException aborts the run regardless of how close
    # the iterate is, src/linear_solver.jl:40-43.)
    res_prev = jnp.maximum(jnp.maximum(state.inf_pr, state.inf_du), state.inf_compl)
    salvage = bad & (res_prev <= cfg.acceptable_tol)
    status = jnp.where(
        salvage,
        int(Status.SOLVED_TO_ACCEPTABLE_LEVEL),
        jnp.where(bad, int(Status.ERROR_IN_STEP_COMPUTATION), state.status),
    ).astype(jnp.int32)
    keep = lambda new, old: jnp.where(salvage, old, new)
    x, y = keep(x, state.x), keep(y, state.y)
    zl, zu = keep(zl, state.zl), keep(zu, state.zu)
    lb_new, ub_new = keep(lb_new, state.lb), keep(ub_new, state.ub)

    prod_out = None
    if products is not None:
        ax0, aty0, adx, atdy = products
        nan = jnp.asarray(jnp.nan, ax0.dtype)
        # bad & ~salvage: x was stepped with non-finite pieces — poison the
        # pair (matches A @ x_new having NaNs) so update_termination cannot
        # flip the lane to SOLVED off a fictitious finite residual.
        ax_new = jnp.where(
            salvage, ax0, jnp.where(bad, nan, ax0 + alpha_p * adx)
        )
        aty_new = jnp.where(
            salvage, aty0, jnp.where(bad, nan, aty0 + alpha_d * atdy)
        )
        prod_out = (ax_new, aty_new)

    new_state = state._replace(
        x=x, y=y, zl=zl, zu=zu, lb=lb_new, ub=ub_new,
        dx=dx, dy=dy, dzl=dzl, dzu=dzu,
        mu=mu_new, mu_curr=mu_curr,
        alpha_p=alpha_p, alpha_d=alpha_d,
        del_w=del_w, del_c=del_c, reg_p=reg_p, reg_d=reg_d,
        k=state.k + 1,
        status=status,
    )
    if prod_out is not None:
        return new_state, prod_out[0], prod_out[1]
    return new_state


def iteration(
    cfg: SolverConfig, prob: DeviceQP, state: IPMState, ax=None, aty=None,
    active=None, return_products=False,
) -> IPMState:
    """One MPC iteration: the three phases composed (fused under jit; XLA
    schedules across the phase boundaries exactly as before the split).

    ``active`` (optional traced bool): finished-lane neutralization.  When
    given and False, the iteration runs on a SANITIZED system — Sigma
    pinned to 1, factor-retry disarmed, solve rhs zeroed — so that a
    converged/terminated lane executing under vmap's select-masking cannot
    drive the data-dependent inner loops (factor retries, PCG budgets) that
    set every lane's trip counts.  The caller is responsible for discarding
    the resulting state for inactive lanes (see _loop_body); results for
    such lanes are meaningless by construction.
    """
    # A x / A' y for the CURRENT iterate, computed once and shared by the
    # predictor and corrector rhs builds (and, via _loop_body, the
    # termination check): fp64 A-applications are a large share of the
    # per-iteration work, so the same product is never evaluated twice.
    if ax is None or aty is None:
        prob_b = dataclasses.replace(prob, lb=state.lb, ub=state.ub)
        if ax is None:
            ax = prob_b.matvec(state.x)
        if aty is None:
            aty = prob_b.rmatvec(state.y)
    factors, del_w, del_c, reg_p, reg_d = _factor_phase(cfg, prob, state, active)
    if return_products:
        (dx, dy, dzl, dzu, mu_new, mu_curr, solve_bad, adx, atdy) = (
            _direction_phase(
                cfg, prob, state, factors, ax, aty, active,
                return_products=True,
            )
        )
        return _step_phase(
            cfg, prob, state, dx, dy, dzl, dzu, mu_new, mu_curr, solve_bad,
            del_w, del_c, reg_p, reg_d, products=(ax, aty, adx, atdy),
        )
    dx, dy, dzl, dzu, mu_new, mu_curr, solve_bad = _direction_phase(
        cfg, prob, state, factors, ax, aty, active
    )
    return _step_phase(
        cfg, prob, state, dx, dy, dzl, dzu, mu_new, mu_curr, solve_bad,
        del_w, del_c, reg_p, reg_d,
    )


# ---------------------------------------------------------------------------
# Drivers
# ---------------------------------------------------------------------------

#: trips between least-squares-certificate refreshes (see
#: kernels.ls_infeasibility_certificate).  The stall classifier needs >=100
#: stalled iterations before the certificate matters, so a 16-trip-stale
#: certificate only delays a legitimate INFEASIBLE exit by <= 16 iterations
#: while amortizing the extra A'-matvec to ~6% of one per iteration.
#: The period must be HOST-SIDE structure (solve_device's nested loop, or
#: the host loops of the chunked/logged/timed drivers) — a trip-counter
#: lax.cond does NOT survive vmap: the while_loop batching rule
#: select-masks every carry against the batched predicate, so the counter
#: becomes per-lane and the cond lowers to a both-branches select_n,
#: running the certificate matvec EVERY iteration (measured as advisor
#: finding r2-medium).
CERT_PERIOD = 16


def _refresh_cert(cfg: SolverConfig, prob: DeviceQP, state: IPMState) -> IPMState:
    """Re-evaluate the least-squares infeasibility certificate (one A and
    one A' application), called once per CERT_PERIOD-iteration chunk.

    The min_residual floor rejects certificates at near-feasible iterates
    (where r -> 0 makes the acceptance trivially true): a momentarily
    near-feasible iterate must not latch a stale True for a later stall at
    a different iterate to consume.  sqrt(tol)*max(1,||b||) mirrors the
    stall classifier's own inf_pr > sqrt(tol) gate on the scaled residual.
    """
    p = dataclasses.replace(prob, lb=state.lb, ub=state.ub)
    min_res = jnp.sqrt(cfg.tol) * jnp.maximum(1.0, state.norm_b)
    return state._replace(
        ls_cert=K.ls_infeasibility_certificate(p, state.x, min_residual=min_res)
    )


def _loop_body(
    cfg: SolverConfig, prob: DeviceQP, state: IPMState, ax=None, aty=None
):
    # One A x / A' y pair per loop trip, shared between the termination
    # check and the iteration's rhs builds (see kernels.eval_cons_residual).
    # When the caller CARRIES the pair across trips (solve_device's inner
    # loop, cfg.product_recurrence), it arrives as arguments, the iteration
    # returns the recurrence-advanced pair, and this function returns
    # ``(state, ax', aty')`` instead of the bare state — saving both
    # A-applications on every trip between the CERT_PERIOD exact resyncs.
    carried = ax is not None and aty is not None
    if not carried:
        ax = prob.matvec(state.x)
        aty = prob.rmatvec(state.y)
    state = update_termination(cfg, prob, state, ax, aty)
    # Finished-lane neutralization (docs/design.md "masked batch exit"):
    # under vmap a non-REGULAR lane cannot skip the iteration (lax.cond on
    # per-lane status lowers to select, both branches execute), so it runs
    # a NEUTRALIZED iteration — Sigma=1, factor-retry disarmed, solve rhs
    # zeroed — whose data-dependent loops (retry while_loop, PCG budgets)
    # exit immediately instead of grinding the lane's terminal barrier
    # system and dragging every active lane's trip counts with it.  The
    # neutralized result is then discarded lane-wise.  Unbatched, the
    # enclosing while_loop predicate already guarantees active=True and the
    # selects fold away.
    active = state.status == jnp.asarray(int(Status.REGULAR), jnp.int32)
    if carried:
        new, ax_n, aty_n = iteration(
            cfg, prob, state, ax, aty, active=active, return_products=True
        )
        out = jax.tree_util.tree_map(
            lambda a, b: jnp.where(active, a, b), new, state
        )
        # The carried pair follows the same lane-wise discard as the state:
        # an inactive lane keeps the pair of the iterate it keeps.
        return (
            out,
            jnp.where(active, ax_n, ax),
            jnp.where(active, aty_n, aty),
        )
    new = iteration(cfg, prob, state, ax, aty, active=active)
    return jax.tree_util.tree_map(
        lambda a, b: jnp.where(active, a, b), new, state
    )


def solve_device(cfg: SolverConfig, prob: DeviceQP) -> Tuple[DeviceQP, ScaleInfo, IPMState]:
    """Whole solve as one traced program (jit-compatible).

    Refactorizes every iteration, like the reference (src/solver.jl:299-303).
    A stale-preconditioner variant (carry the factor across trips, rebuild
    only Sigma^-1) was measured and REJECTED: Sigma moves by decades per
    early-IPM iteration, so even a one-iteration-old factor blew a 12-
    iteration solve up to 66 iterations (period 2), and at period 3 the
    resulting garbage steps stalled inf_pr long enough to trip the
    infeasibility-by-stall classifier on a feasible LP — a correctness
    footgun, not just a perf loss (docs/design.md round-2 notes).

    Nested-loop structure: the outer while_loop runs one certificate
    refresh + an inner while_loop of up to CERT_PERIOD ordinary iterations.
    The period is thus encoded in the PROGRAM (trip-count bound), not in a
    carried counter, so it survives vmap — see the CERT_PERIOD note.
    """
    prob_s, scale, state = initialize(cfg, prob)

    def outer(state):
        state = _refresh_cert(cfg, prob_s, state)

        if cfg.product_recurrence:
            # Exact A x / A' y at the chunk boundary (the recurrence
            # resync), then carry the pair through the inner trips.
            ax = prob_s.matvec(state.x)
            aty = prob_s.rmatvec(state.y)

            def inner_cond(c):
                s, _ax, _aty, i = c
                return (s.status == int(Status.REGULAR)) & (i < CERT_PERIOD)

            def inner_body(c):
                s, ax_, aty_, i = c
                s, ax_, aty_ = _loop_body(cfg, prob_s, s, ax_, aty_)
                return s, ax_, aty_, i + 1

            state, _, _, _ = lax.while_loop(
                inner_cond, inner_body, (state, ax, aty, jnp.asarray(0))
            )
            return state

        def inner_cond(c):
            s, i = c
            return (s.status == int(Status.REGULAR)) & (i < CERT_PERIOD)

        def inner_body(c):
            s, i = c
            return _loop_body(cfg, prob_s, s), i + 1

        state, _ = lax.while_loop(inner_cond, inner_body, (state, jnp.asarray(0)))
        return state

    state = lax.while_loop(
        lambda s: s.status == int(Status.REGULAR), outer, state
    )
    return prob_s, scale, state


def solve_device_chunked(
    cfg: SolverConfig,
    prob: DeviceQP,
    max_wall_time: float,
    chunk: int = 25,
) -> Tuple[DeviceQP, ScaleInfo, IPMState]:
    """Fused solve with an in-loop wall-time guard (reference
    src/solver.jl:216): runs the device while_loop in chunks of up to
    ``chunk`` iterations per host round-trip, checking the clock between
    chunks.  The per-chunk status fetch costs one device sync every
    ``chunk`` iterations — negligible against the guard it buys; the
    fully-fused :func:`solve_device` (no guard) remains the benchmark path.
    """
    t0 = time.time()
    init = jax.jit(partial(initialize, cfg))

    def _chunk(prob_, state_):
        # Certificate refreshed once per host chunk (<= max(chunk,
        # CERT_PERIOD)-stale; same staleness argument as CERT_PERIOD).
        state_ = _refresh_cert(cfg, prob_, state_)

        if cfg.product_recurrence:
            # Exact pair at the chunk boundary, recurrence inside (see
            # solve_device); chunk <= 25 keeps the same drift bound class.
            ax = prob_.matvec(state_.x)
            aty = prob_.rmatvec(state_.y)

            def body(carry):
                s, ax_, aty_, i = carry
                s, ax_, aty_ = _loop_body(cfg, prob_, s, ax_, aty_)
                return s, ax_, aty_, i + 1

            def cond(carry):
                s, _ax, _aty, i = carry
                return (s.status == int(Status.REGULAR)) & (i < chunk)

            state_, _, _, _ = lax.while_loop(
                cond, body, (state_, ax, aty, jnp.asarray(0))
            )
            return state_

        def body(carry):
            s, i = carry
            return _loop_body(cfg, prob_, s), i + 1

        def cond(carry):
            s, i = carry
            return (s.status == int(Status.REGULAR)) & (i < chunk)

        state_, _ = lax.while_loop(cond, body, (state_, jnp.asarray(0)))
        return state_

    run_chunk = jax.jit(_chunk)
    prob_s, scale, state = init(prob)
    while True:
        # The host needs the status to decide whether to continue.
        import numpy as _np

        status = int(_np.asarray(state.status))
        if status != int(Status.REGULAR):
            break
        if time.time() - t0 >= max_wall_time:
            # One final termination check: the last chunk's iterate may
            # already satisfy the (acceptable) tolerance.
            state = jax.jit(partial(update_termination, cfg))(prob_s, state)
            if int(_np.asarray(state.status)) == int(Status.REGULAR):
                state = state._replace(
                    status=jnp.asarray(
                        int(Status.MAXIMUM_WALLTIME_EXCEEDED), jnp.int32
                    )
                )
            break
        state = run_chunk(prob_s, state)
    return prob_s, scale, state


def solve_logged(
    cfg: SolverConfig,
    prob: DeviceQP,
    print_fn=print,
    max_wall_time: float = 1e6,
) -> Tuple[DeviceQP, ScaleInfo, IPMState]:
    """Python-driven loop with the reference's per-iteration log
    (src/structure.jl:180-197) and wall-time guard (src/solver.jl:216)."""
    t0 = time.time()
    init = jax.jit(partial(initialize, cfg))
    term = jax.jit(partial(update_termination, cfg))
    step = jax.jit(partial(iteration, cfg))

    prob_s, scale, state = init(prob)
    certf = jax.jit(partial(_refresh_cert, cfg))
    header = "iter    objective    inf_pr   inf_du lg(mu)  ||d||  lg(rg) alpha_du alpha_pr"
    trip = 0
    while True:
        if trip % CERT_PERIOD == 0:
            state = certf(prob_s, state)
        trip += 1
        state = term(prob_s, state)
        k = int(state.k)
        if k % 10 == 0:
            print_fn(header)
        osc = float(scale.obj_scale)
        dnorm = float(jnp.max(jnp.abs(state.dx))) if k > 0 else 0.0
        dw = float(state.del_w)
        lg_rg = "   - " if dw == 0 else f"{jnp.log10(dw):5.1f}"
        print_fn(
            f"{k:4d}  {float(state.obj_val)/osc: 10.7e} {float(state.inf_pr):6.2e} "
            f"{float(state.inf_du):6.2e} {float(jnp.log10(jnp.maximum(state.mu, 1e-300))):5.1f} "
            f"{dnorm:6.2e} {lg_rg} {float(state.alpha_d):6.2e} {float(state.alpha_p):6.2e}"
        )
        if int(state.status) != int(Status.REGULAR):
            break
        if time.time() - t0 >= max_wall_time:
            state = state._replace(
                status=jnp.asarray(int(Status.MAXIMUM_WALLTIME_EXCEEDED), jnp.int32)
            )
            break
        state = step(prob_s, state)
    return prob_s, scale, state


def solve_timed(
    cfg: SolverConfig,
    prob: DeviceQP,
    max_wall_time: float = 1e6,
) -> Tuple[DeviceQP, ScaleInfo, IPMState, dict]:
    """Python-driven loop with per-phase wall timers.

    Returns ``(prob_s, scale, state, timers)`` where ``timers`` carries
    ``linear_solver_time`` (factorization + KKT solves across the MPC loop
    — the reference's MadNLPCounters.linear_solver_time recorded per
    benchmark instance, scripts/benchmarks_cpu.jl:50), plus ``eval_time``
    (A-matvecs + termination) and ``step_time`` (step rule/apply).

    Accounting notes: the initialization's factorization + two solves land
    in the caller's init accounting, not here (the reference counts them
    under linear_solver_time; at >=10 MPC iterations the difference is
    noise).  The A-matvec pair AND the predictor rhs build are computed in
    the eval phase, so linear_solver_time covers exactly the reference's
    factorize+solve span (src/linear_solver.jl:6-44) — the only non-solve
    work left inside it (corrector/Gondzio rhs assembly from the already-
    computed pair) is elementwise O(n) glue.  Each phase is synced with a
    host fetch, so every phase carries a host round trip — use the fused
    solve_device for throughput numbers and this driver for the
    linear-solver-time breakdown.
    """
    t0 = time.time()
    init = jax.jit(partial(initialize, cfg))
    term = jax.jit(partial(update_termination, cfg))

    def _eval(prob_, state_):
        p = dataclasses.replace(prob_, lb=state_.lb, ub=state_.ub)
        ax = p.matvec(state_.x)
        aty = p.rmatvec(state_.y)
        rhs_aff = K.predictor_rhs(
            p, state_.x, state_.y, state_.zl, state_.zu, ax, aty
        )
        return ax, aty, rhs_aff

    evalf = jax.jit(_eval)
    fact = jax.jit(partial(_factor_phase, cfg))
    dirs = jax.jit(partial(_direction_phase, cfg))
    stepf = jax.jit(partial(_step_phase, cfg))

    import numpy as _np

    prob_s, scale, state = init(prob)
    _np.asarray(state.k)  # sync: init complete before the loop timers start
    timers = {"linear_solver_time": 0.0, "eval_time": 0.0, "step_time": 0.0}
    certf = jax.jit(partial(_refresh_cert, cfg))
    trip = 0
    while True:
        t1 = time.time()
        if trip % CERT_PERIOD == 0:
            state = certf(prob_s, state)
        trip += 1
        ax, aty, rhs_aff = evalf(prob_s, state)
        state = term(prob_s, state, ax, aty)
        status = int(_np.asarray(state.status))  # sync
        timers["eval_time"] += time.time() - t1
        if status != int(Status.REGULAR):
            break
        if time.time() - t0 >= max_wall_time:
            state = state._replace(
                status=jnp.asarray(int(Status.MAXIMUM_WALLTIME_EXCEEDED), jnp.int32)
            )
            break
        t1 = time.time()
        factors, del_w, del_c, reg_p, reg_d = fact(prob_s, state)
        out = dirs(prob_s, state, factors, ax, aty, None, rhs_aff)
        _np.asarray(out[4])  # sync: mu_new forces factor+direction programs
        timers["linear_solver_time"] += time.time() - t1
        t1 = time.time()
        state = stepf(prob_s, state, *out, del_w, del_c, reg_p, reg_d)
        _np.asarray(state.k)  # sync
        timers["step_time"] += time.time() - t1
    return prob_s, scale, state, timers
