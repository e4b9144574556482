"""Per-iteration vector math of the predictor-corrector solver.

Functional, fully masked analogue of the reference's kernels
(reference: src/kernels.jl).  Every routine is a pure function over padded
full-length arrays; masked reductions replace the reference's SubVector
views, which keeps everything one fused XLA computation with static shapes —
no gathers, no host syncs (the reference needed ``CUDA.@allowscalar`` for the
GTSF step rule, src/kernels.jl:333-353; here the argmin gathers stay
on-device).

Sign conventions (equivalent to the reference's, verified by
tests/test_kkt.py):

    r_d = grad + A' y - zl + zu                 (dual residual)
    r_p = A x - b                               (primal residual)
    (3)  zl dx + sl dzl = rl,  sl = x - lb      (lower complementarity row)
    (4) -zu dx + su dzu = ru,  su = ub - x      (upper complementarity row)

with rl = -sl zl (affine), rl = sigma*mu - sl zl - corr_l (corrector);
condensed rhs rx = -r_d + rl/sl - ru/su feeding the KKT solve
[Sigma+Q, A'; A, del_c] [dx; dy] = [rx; -r_p].
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from ..models.qp import DeviceQP

_BIG = jnp.inf


def _masked_min(vals, mask, init):
    return jnp.minimum(init, jnp.min(jnp.where(mask, vals, _BIG)))


def _masked_max_abs(vals, mask):
    return jnp.max(jnp.where(mask, jnp.abs(vals), 0.0))


def _masked_sum(vals, mask):
    return jnp.sum(jnp.where(mask, vals, 0.0))


# ---------------------------------------------------------------------------
# Problem evaluations (the reference's MadNLP callback wrappers,
# src/solver.jl:166-170,319-325)
# ---------------------------------------------------------------------------


def slacks(prob: DeviceQP, x):
    sl = jnp.where(prob.has_lb, x - prob.lb, 1.0)
    su = jnp.where(prob.has_ub, prob.ub - x, 1.0)
    return sl, su


def eval_obj(prob: DeviceQP, x):
    v = prob.c0 + jnp.dot(prob.c, x, preferred_element_type=x.dtype)
    if prob.is_qp:
        v = v + 0.5 * jnp.dot(x, prob.qmatvec(x), preferred_element_type=x.dtype)
    return v


def eval_grad(prob: DeviceQP, x):
    g = prob.c
    if prob.is_qp:
        g = g + prob.qmatvec(x)
    return g


def eval_cons_residual(prob: DeviceQP, x, ax=None):
    """A x - b, zeroed on padded rows (reference solver.c after rhs shift).

    ``ax`` optionally supplies a precomputed A x: the fp64 A-applications are
    a large share of the per-iteration work, and
    the termination check, predictor rhs, and corrector rhs all evaluate the
    SAME A x / A' y pair — the driver computes it once and threads it through.
    """
    r = (prob.matvec(x) if ax is None else ax) - prob.b
    return jnp.where(prob.row_mask, r, 0.0)


def eval_jty(prob: DeviceQP, y):
    """A' y (the reference's jacl, src/solver.jl:187,324)."""
    return prob.rmatvec(y)


def dual_residual(prob: DeviceQP, x, y, zl, zu, aty=None):
    """grad + A'y - zl + zu on free columns (reference MadNLP.get_inf_du args).

    ``aty`` optionally supplies a precomputed A' y (see eval_cons_residual).
    """
    r = eval_grad(prob, x) + (eval_jty(prob, y) if aty is None else aty) - zl + zu
    return jnp.where(prob.free_mask, r, 0.0)


# ---------------------------------------------------------------------------
# Convergence measures (reference: src/solver.jl:194-222, src/kernels.jl:403-430)
# ---------------------------------------------------------------------------


def primal_infeasibility(prob: DeviceQP, x, ax=None):
    return _masked_max_abs(eval_cons_residual(prob, x, ax), prob.row_mask)


def dual_infeasibility(prob: DeviceQP, x, y, zl, zu, aty=None):
    return _masked_max_abs(dual_residual(prob, x, y, zl, zu, aty), prob.free_mask)


def ls_infeasibility_certificate(prob: DeviceQP, x, ax=None, min_residual=0.0):
    """Is the current iterate (approximately) a least-squares infeasibility
    certificate — a stationary point of min ||A x - b||^2 s.t. lb<=x<=ub
    with a nonzero residual?

    On a genuinely infeasible LP the MPC iterates converge to exactly such
    a point (inf_du, compl -> 0, inf_pr stuck at the LS distance), and the
    projected gradient of the LS objective vanishes there up to solve
    accuracy.  On a FEASIBLE instance that merely grinds (linear-solve
    noise pinning inf_pr at ~1e-4), the LS optimum
    is zero, so the projected gradient at the stalled point stays O(||r||)
    — orders above the 1e-2*||r||_inf acceptance used here.  This is the
    gate that keeps the infeasibility-by-stall classifier
    (driver.update_termination) from misclassifying feasible instances;
    the reference has no analogue (its stall exits are max_iter only).

    One A'-matvec per evaluation; the fused driver amortizes it by
    evaluating once per CERT_PERIOD-trip inner chunk of its nested loop
    (driver.solve_device) — a host-period structure that survives vmap,
    unlike a trip-counter lax.cond (the while_loop batching rule
    select-masks every carry, turning such a cond into a both-branches
    select).

    ``min_residual``: certificates at near-feasible iterates are rejected
    (r -> 0 makes the 1e-2*r_inf acceptance trivially true; a momentarily
    near-feasible iterate could otherwise latch a stale True that a LATER
    stall at a different iterate consumes).  The driver passes
    sqrt(tol)*max(1,||b||) — the same floor the stall classifier applies to
    its scaled inf_pr gate, so a certificate can only be True where the
    classifier could actually fire.
    """
    r = eval_cons_residual(prob, x, ax)
    g = prob.rmatvec(r)
    r_inf = _masked_max_abs(r, prob.row_mask)
    # Bound activity at the iterate (relative slack; barrier iterates sit
    # ~mu/z off the bound, far inside this tolerance at a stall).
    sl = x - prob.lb
    su = prob.ub - x
    act_l = prob.has_lb & (sl <= 1e-6 * (1.0 + jnp.abs(x)))
    act_u = prob.has_ub & (su <= 1e-6 * (1.0 + jnp.abs(x)))
    # Stationarity violation of min ||Ax-b||^2 over the box: interior
    # components need g ~ 0; at a lower bound only g >= 0 is required
    # (increase is the only feasible move), at an upper bound g <= 0.
    pg = jnp.where(
        act_l, jnp.minimum(g, 0.0), jnp.where(act_u, jnp.maximum(g, 0.0), g)
    )
    pg_inf = _masked_max_abs(pg, prob.free_mask)
    return (pg_inf <= 1e-2 * r_inf) & (r_inf > min_residual)


def complementarity_inf(prob: DeviceQP, x, zl, zu, mu=0.0):
    """max |s.z - mu| over both bound families (MadNLP.get_inf_compl)."""
    sl, su = slacks(prob, x)
    cl = _masked_max_abs(sl * zl - mu, prob.has_lb)
    cu = _masked_max_abs(su * zu - mu, prob.has_ub)
    return jnp.maximum(cl, cu)


def complementarity_measure(prob: DeviceQP, x, zl, zu):
    """mu = sum(s.z)/(m1+m2) (reference get_complementarity_measure,
    src/kernels.jl:155-174)."""
    sl, su = slacks(prob, x)
    m1 = jnp.sum(prob.has_lb)
    m2 = jnp.sum(prob.has_ub)
    tot = _masked_sum(sl * zl, prob.has_lb) + _masked_sum(su * zu, prob.has_ub)
    denom = jnp.maximum(m1 + m2, 1)
    return jnp.where(m1 + m2 == 0, 0.0, tot / denom)


def affine_complementarity_measure(prob: DeviceQP, x, zl, zu, dx, dzl, dzu, alpha_p, alpha_d):
    """Complementarity at the trial point (reference
    get_affine_complementarity_measure, src/kernels.jl:176-208)."""
    sl, su = slacks(prob, x)
    m1 = jnp.sum(prob.has_lb)
    m2 = jnp.sum(prob.has_ub)
    tl = (sl + alpha_p * dx) * (zl + alpha_d * dzl)
    tu = (su - alpha_p * dx) * (zu + alpha_d * dzu)
    tot = _masked_sum(tl, prob.has_lb) + _masked_sum(tu, prob.has_ub)
    denom = jnp.maximum(m1 + m2, 1)
    return jnp.where(m1 + m2 == 0, 0.0, tot / denom)


def dual_objective(prob: DeviceQP, y, zl, zu):
    """dobj = -y'b + zl'lb - zu'ub (reference src/kernels.jl:408-417)."""
    dobj = -jnp.dot(y, jnp.where(prob.row_mask, prob.b, 0.0))
    dobj = dobj + _masked_sum(zl * prob.lb, prob.has_lb)
    dobj = dobj - _masked_sum(zu * prob.ub, prob.has_ub)
    return dobj


# ---------------------------------------------------------------------------
# Right-hand sides (reference: src/kernels.jl:1-71)
# ---------------------------------------------------------------------------


class CondensedRHS(NamedTuple):
    rx: jax.Array  # [n] condensed primal rhs
    rp: jax.Array  # [m] dual-block rhs (= b - A x)
    rl: jax.Array  # [n] lower complementarity rhs (eq. 3)
    ru: jax.Array  # [n] upper complementarity rhs (eq. 4)


def predictor_rhs(prob: DeviceQP, x, y, zl, zu, ax=None, aty=None) -> CondensedRHS:
    """Affine-scaling rhs (reference set_predictive_rhs!, src/kernels.jl:21-41)."""
    sl, su = slacks(prob, x)
    rl = jnp.where(prob.has_lb, -sl * zl, 0.0)
    ru = jnp.where(prob.has_ub, -su * zu, 0.0)
    return _condense(prob, x, y, zl, zu, rl, ru, ax, aty)


def corrector_rhs(
    prob: DeviceQP, x, y, zl, zu, mu, corr_l, corr_u, ax=None, aty=None
) -> CondensedRHS:
    """Corrector rhs with centering + complementarity correction
    (reference set_correction_rhs!, src/kernels.jl:43-58)."""
    sl, su = slacks(prob, x)
    rl = jnp.where(prob.has_lb, mu - sl * zl - corr_l, 0.0)
    ru = jnp.where(prob.has_ub, mu - su * zu - corr_u, 0.0)
    return _condense(prob, x, y, zl, zu, rl, ru, ax, aty)


def _condense(prob, x, y, zl, zu, rl, ru, ax=None, aty=None) -> CondensedRHS:
    sl, su = slacks(prob, x)
    px = -dual_residual(prob, x, y, zl, zu, aty)
    rx = px + jnp.where(prob.has_lb, rl / sl, 0.0) - jnp.where(prob.has_ub, ru / su, 0.0)
    rx = jnp.where(prob.free_mask, rx, 0.0)
    rp = -eval_cons_residual(prob, x, ax)
    return CondensedRHS(rx=rx, rp=rp, rl=rl, ru=ru)


def recover_bound_duals(prob: DeviceQP, x, zl, zu, rhs: CondensedRHS, dx):
    """dzl, dzu from the complementarity rows (the reference's
    finish_aug_solve!, src/KKT/normalkkt.jl:217)."""
    sl, su = slacks(prob, x)
    dzl = jnp.where(prob.has_lb, (rhs.rl - zl * dx) / sl, 0.0)
    dzu = jnp.where(prob.has_ub, (rhs.ru + zu * dx) / su, 0.0)
    return dzl, dzu


def mehrotra_correction(prob: DeviceQP, dx, dzl, dzu):
    """corr_l = dx.dzl, corr_u = -dx.dzu (reference get_correction!,
    src/kernels.jl:60-71; upper sign folded into our eq.-4 convention)."""
    corr_l = jnp.where(prob.has_lb, dx * dzl, 0.0)
    corr_u = jnp.where(prob.has_ub, -dx * dzu, 0.0)
    return corr_l, corr_u


def gondzio_extra_correction(
    prob: DeviceQP, x, zl, zu, dx, dzl, dzu, corr_l, corr_u,
    alpha_p, alpha_d, beta_min, beta_max, mu,
):
    """Gondzio centrality correction (reference set_extra_correction!,
    src/kernels.jl:74-122): clip trial pairwise products into
    [beta_min*mu, beta_max*mu]."""
    sl, su = slacks(prob, x)
    tmin, tmax = beta_min * mu, beta_max * mu

    vl = (sl + alpha_p * dx) * (zl + alpha_d * dzl)
    dl = jnp.where(vl < tmin, tmin - vl, jnp.where(vl > tmax, tmax - vl, 0.0))
    corr_l = jnp.where(prob.has_lb, corr_l - dl, 0.0)

    vu = (su - alpha_p * dx) * (zu + alpha_d * dzu)
    du_ = jnp.where(vu < tmin, tmin - vu, jnp.where(vu > tmax, tmax - vu, 0.0))
    corr_u = jnp.where(prob.has_ub, corr_u - du_, 0.0)
    return corr_l, corr_u


# ---------------------------------------------------------------------------
# Step lengths (reference: src/kernels.jl:222-358)
# ---------------------------------------------------------------------------


class AlphaMax(NamedTuple):
    alpha_xl: jax.Array
    alpha_xu: jax.Array
    alpha_zl: jax.Array
    alpha_zu: jax.Array
    i_xl: jax.Array  # argmin indices (full-vector positions), for GTSF
    i_xu: jax.Array
    i_zl: jax.Array
    i_zu: jax.Array


def _masked_argmin_ratio(vals, mask):
    """(min(1, masked min), argmin position). init=(1.0, 0) like the reference."""
    v = jnp.where(mask, vals, _BIG)
    i = jnp.argmin(v)
    return jnp.minimum(1.0, v[i]), i


def alpha_max(prob: DeviceQP, x, zl, zu, dx, dzl, dzu, tau) -> AlphaMax:
    """Blocking step ratios per bound family (reference get_alpha_max_primal /
    get_alpha_max_dual, src/kernels.jl:226-272), argmin-tracked."""
    sl, su = slacks(prob, x)
    a_xl, i_xl = _masked_argmin_ratio(-sl * tau / dx, prob.has_lb & (dx < 0))
    a_xu, i_xu = _masked_argmin_ratio(su * tau / dx, prob.has_ub & (dx > 0))
    a_zl, i_zl = _masked_argmin_ratio(-zl * tau / dzl, prob.has_lb & (dzl < 0))
    # NOTE: the reference's upper-dual test additionally requires
    # zu + dzu < 0 (src/kernels.jl:263) — reproduced verbatim.
    a_zu, i_zu = _masked_argmin_ratio(
        -zu * tau / dzu, prob.has_ub & (dzu < 0) & (zu + dzu < 0)
    )
    return AlphaMax(a_xl, a_xu, a_zl, a_zu, i_xl, i_xu, i_zl, i_zu)


def fraction_to_boundary(prob: DeviceQP, x, zl, zu, dx, dzl, dzu, tau):
    """(alpha_p, alpha_d) (reference get_fraction_to_boundary_step,
    src/kernels.jl:274-289)."""
    am = alpha_max(prob, x, zl, zu, dx, dzl, dzu, tau)
    return jnp.minimum(am.alpha_xl, am.alpha_xu), jnp.minimum(am.alpha_zl, am.alpha_zu)


def mehrotra_adaptive_step(
    prob: DeviceQP, x, zl, zu, dx, dzl, dzu, gamma_f,
):
    """Mehrotra's boundary-point heuristic (Procedure GTSF; reference
    update_step! for MehrotraAdaptiveStep, src/kernels.jl:309-358).

    The reference needs scalar indexing at the argmin entries (its GPU path
    comments out ``CUDA.@allowscalar``); here the gathers compile into the
    fused program.
    """
    gamma_a = 1.0 / (1.0 - gamma_f)
    am = alpha_max(prob, x, zl, zu, dx, dzl, dzu, 1.0)
    max_alpha_p = jnp.minimum(am.alpha_xl, am.alpha_xu)
    max_alpha_d = jnp.minimum(am.alpha_zl, am.alpha_zu)

    mu_full = affine_complementarity_measure(
        prob, x, zl, zu, dx, dzl, dzu, max_alpha_p, max_alpha_d
    ) / gamma_a

    sl, su = slacks(prob, x)

    # Primal side
    tmp_l = mu_full / (zl[am.i_xl] + max_alpha_d * dzl[am.i_xl])
    ap_l = (sl[am.i_xl] - tmp_l) / (-dx[am.i_xl])
    tmp_u = mu_full / (zu[am.i_xu] + max_alpha_d * dzu[am.i_xu])
    ap_u = (su[am.i_xu] - tmp_u) / dx[am.i_xu]
    alpha_p = jnp.where(
        max_alpha_p < 1.0, jnp.where(am.alpha_xl <= am.alpha_xu, ap_l, ap_u), 1.0
    )

    # Dual side
    tmp_zl = mu_full / (sl[am.i_zl] + max_alpha_p * dx[am.i_zl])
    ad_l = -(zl[am.i_zl] - tmp_zl) / dzl[am.i_zl]
    tmp_zu = mu_full / (su[am.i_zu] - max_alpha_p * dx[am.i_zu])
    ad_u = -(zu[am.i_zu] - tmp_zu) / dzu[am.i_zu]
    alpha_d = jnp.where(
        max_alpha_d < 1.0, jnp.where(am.alpha_zl <= am.alpha_zu, ad_l, ad_u), 1.0
    )

    alpha_p = jnp.maximum(alpha_p, gamma_f * max_alpha_p)
    alpha_d = jnp.maximum(alpha_d, gamma_f * max_alpha_d)
    return alpha_p, alpha_d


# ---------------------------------------------------------------------------
# Barrier update (reference update_barrier!, src/kernels.jl:210-220)
# ---------------------------------------------------------------------------


def mehrotra_barrier(
    prob: DeviceQP, x, zl, zu, mu_affine, mu_min,
    power=3.0, sigma_min=1e-6, sigma_max=10.0,
):
    # The reference gates Mehrotra centering on
    # length(ind_llb)+length(ind_uub) > 0 (src/kernels.jl:211) and falls back
    # to sigma = 1 otherwise — a guard against 0/0 when the problem has no
    # bound constraints.  We gate on "any bounded variable exists": for the
    # pure-equality case both agree (sigma irrelevant, mu_curr = 0), while
    # for fully two-sided-bounded problems sigma = 1 would freeze mu and
    # stall the solver.  (power, sigma_min, sigma_max) come from the
    # Mehrotra barrier-update strategy (utils/options.py; reference
    # update_barrier! dispatch, src/solver.jl:235 + src/kernels.jl:210-220).
    n_bounded = jnp.sum(prob.has_lb) + jnp.sum(prob.has_ub)
    mu_curr = complementarity_measure(prob, x, zl, zu)
    sigma = jnp.where(
        n_bounded > 0,
        jnp.clip(
            (mu_affine / jnp.maximum(mu_curr, 1e-300)) ** power,
            sigma_min,
            sigma_max,
        ),
        1.0,
    )
    mu_new = jnp.maximum(mu_min, sigma * mu_curr)
    return mu_new, mu_curr


# ---------------------------------------------------------------------------
# Boundary adjustment (MadNLP.adjust_boundary!, called from apply_step!,
# reference src/solver.jl:313)
# ---------------------------------------------------------------------------


def adjust_boundary(prob: DeviceQP, x, mu):
    """Nudge bounds away from iterates that numerically touch them.

    Epsilon-level safeguard mirroring MadNLP's adjust_boundary!: whenever the
    slack falls below eps*mu the bound is pushed out so strict interiority
    is preserved.  Returns adjusted (lb, ub) used for the *next* iteration's
    slack computations via the problem's bounds; since DeviceQP is immutable
    we return replacement bounds.
    """
    eps = jnp.finfo(x.dtype).eps
    c1 = eps * mu
    c2 = eps ** 0.75
    lb, ub = prob.lb, prob.ub
    pad = c2 * jnp.maximum(1.0, jnp.abs(x))
    lb_new = jnp.where(prob.has_lb & (x - lb < c1), x - pad, lb)
    ub_new = jnp.where(prob.has_ub & (ub - x < c1), x + pad, ub)
    return lb_new, ub_new
