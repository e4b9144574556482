"""KKT-system formulations.

Functional (stateless) analogue of the reference's KKT abstraction layer
(reference: src/KKT/normalkkt.jl plus the MadNLP SparseKKTSystem /
ScaledSparseKKTSystem family selected via ``IPMOptions.kkt_system``,
src/utils.jl:71,110).  Two formulations:

- **NORMAL** (LP only, like the reference's ``NormalKKTSystem``,
  src/KKT/normalkkt.jl:29-140): condense the augmented system onto the dual
  block and factorize the SPD normal matrix ``S = A Sigma^-1 A' - del_c I``
  of size m.  The dense assembly is one big matmul
  ``(A * dinv) @ A.T`` instead of the reference's row-intersection sparse
  kernel (ext/MadIPMCUDAExt/cuda_wrapper.jl:108-234).

- **AUGMENTED** (K2, LP+QP, like MadNLP's SparseKKTSystem): factorize the
  quasi-definite matrix ``[Sigma+Q, A'; A, del_c I]`` with unpivoted LDL'
  (or LU fallback).

Both consume the *condensed* right-hand side (rx, rp) produced by the solver
kernels and return (dx, dy); bound-multiplier recovery (the reference's
``finish_aug_solve!``) lives in solver/kernels.py.

Padding/masking contract (see models/qp.py): fixed and padded columns are
excluded by zeroing their ``dinv`` / KKT rows+cols and pinning the diagonal
to 1; padded constraint rows likewise.  This keeps every factorization
nonsingular with static shapes — the dense replacement for the reference's
index-set views.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from ..models.qp import DeviceQP
from ..utils.options import KKTSystem, LinearSolver
from . import block_chol, linalg


@dataclasses.dataclass(frozen=True)
class KKTConfig:
    """Static configuration of the per-iteration linear solve."""

    kind: KKTSystem
    linear_solver: LinearSolver
    factor_dtype: jnp.dtype
    refinement_steps: int = 2
    max_factor_trials: int = 3  # reference: src/linear_solver.jl:7
    #: precondition the fp64 PCG with an inner fp32 CG (flexible PCG,
    #: Polak–Ribière).  At the bench shape the plain fp32-factor
    #: preconditioner already exits the fp64 PCG after 1-2 iterations, so
    #: the inner CG adds overhead without removing fp64 pairs — default
    #: OFF; available for shapes/conditioning where the factor alone is a
    #: weak preconditioner.
    use_flex_pcg: bool = False
    #: jax.sharding.Mesh for the DISTRIBUTED single-instance path (NORMAL
    #: KKT only): column-sharded Schur assembly reduce-scattered into row
    #: strips + distributed panel Cholesky (parallel/dist_chol.py) — the
    #: m x m matrix and its factor are never materialized on one device.
    #: None (default) = replicated factorization.  Mesh is hashable, so the
    #: config stays a valid static jit argument.
    dist_mesh: Optional[object] = None
    dist_axis: str = "cols"
    #: XLA matmul precision for factor-dtype work (normal-matrix assembly,
    #: the blocked factorization, and every preconditioner application) when
    #: the factor runs BELOW the residual precision.  "high" = 3 bf16
    #: passes, "default" = 1 pass, None inherits the global setting.
    #: Ignored when factor_dtype == residual dtype.  NOTE: measured UNSAFE
    #: at the tol=1e-8 bench config (0/8 solved at both "high" and
    #: "default", for at most +27% rate) — see IPMOptions.factor_precision
    #: for the analysis; the 6-pass "highest" factor is load-bearing there.
    factor_precision: Optional[str] = None
    #: second-order preconditioner: retain the UNSHIFTED Jacobi-scaled
    #: normal matrix and apply one inner correction per preconditioner
    #: application, M⁻¹' b = z + M⁻¹(b − Ŝ z) with z = M⁻¹ b.  The factor
    #: M is built from Ŝ + PRECOND_SHIFT·I, so M⁻¹ alone mis-scales
    #: small-eigenvalue directions by λ/(λ+σ) — exactly the weak-tail
    #: contraction that dominates the late IPM iterations; the correction
    #: cancels the shift error to first order at the cost of one fp32
    #: m×m matvec + one extra factor application (both ~2 orders cheaper
    #: than the fp64 Ozaki pair a saved PCG iteration avoids).  NORMAL +
    #: low-precision-factor path only.  See IPMOptions.precond_refine.
    precond_refine: bool = False


class NormalFactors(NamedTuple):
    L: jax.Array  # Cholesky factor of the Jacobi-scaled S (factor dtype)
    jac: jax.Array  # Jacobi scale d_i = 1/sqrt(S_ii) (factor dtype)
    dinv: jax.Array  # Sigma^-1 with fixed/padded columns zeroed (residual dtype)
    del_c: jax.Array  # dual regularization used in this factorization
    live: jax.Array  # rows actually coupled to variables (excludes padded AND
    #                  empty rows, whose normal diagonal would be -del_c <= 0)
    Smat: jax.Array  # the Jacobi-scaled S itself (factor dtype): the cheap
    #                  inner operator of the mixed-precision restarted PCG
    #                  (one m×m fp32 matmul vs an fp64 A-pair)


class DistNormalFactors(NamedTuple):
    """NORMAL factors with the Cholesky row-strip-sharded over a mesh axis
    (parallel/dist_chol.dist_factor_normal).  Same solve semantics as
    NormalFactors; the preconditioner application runs distributed."""

    L: jax.Array  # [m, m] lower factor, rows sharded over dist_axis
    W: jax.Array  # [m, mb] per-strip inverse diagonal blocks (matmul solves)
    jac: jax.Array  # [m] Jacobi scale (replicated)
    dinv: jax.Array  # Sigma^-1, fixed/padded cols zeroed (residual dtype)
    del_c: jax.Array
    live: jax.Array


class DistCondensedFactors(NamedTuple):
    """K1 condensed factors with the size-n Cholesky row-strip-sharded
    over a mesh axis (parallel/dist_chol.dist_factor_condensed) — the
    multi-chip QP path.  Same solve semantics as CondensedFactors."""

    L: jax.Array  # [n, n] lower factor, rows sharded over dist_axis
    W: jax.Array  # [n, nb] per-strip inverse diagonal blocks
    jac: jax.Array  # [n] Jacobi scale (replicated)
    sigma: jax.Array  # barrier diagonal (residual dtype)
    gamma: jax.Array  # 1/|del_c_eff|
    del_c: jax.Array
    live: jax.Array


class CondensedFactors(NamedTuple):
    """K1 condensed factors (see utils.options.KKTSystem.CONDENSED)."""

    L: jax.Array  # Cholesky factor of the Jacobi-scaled C (factor dtype)
    jac: jax.Array  # Jacobi scale 1/sqrt(C_ii) (factor dtype)
    sigma: jax.Array  # barrier diagonal (residual dtype, refinement matvec)
    gamma: jax.Array  # 1/|del_c_eff| (residual dtype)
    del_c: jax.Array  # effective (negative) dual regularization
    live: jax.Array  # structurally nonempty constraint rows
    Smat: jax.Array  # Jacobi-scaled C (factor dtype), see NormalFactors.Smat


class AugmentedFactors(NamedTuple):
    Lfac: jax.Array  # LDL: unit-lower L; LU: packed LU (factor dtype)
    dfac: jax.Array  # LDL: diagonal d; LU: pivot indices
    sigma: jax.Array  # barrier diagonal (residual dtype, for refinement matvec)
    del_c: jax.Array
    live: jax.Array  # as above: structurally nonempty constraint rows
    jac: jax.Array  # K2.5 symmetric scaling |diag(K)|^-1/2 (ones for plain K2)


# ---------------------------------------------------------------------------
# Sigma (barrier diagonal)
# ---------------------------------------------------------------------------


def build_sigma(prob: DeviceQP, x, zl, zu, del_w):
    """Sigma = del_w + Zl (X - Xl)^-1 + Zu (Xu - X)^-1 on free columns.

    Matches ``set_aug_diagonal_reg!`` (reference: src/kernels.jl:124-136):
    pr_diag = reg - l_lower/l_diag - u_lower/u_diag with l_diag = xl - x < 0.
    Non-free (fixed/padded) columns are pinned to 1.
    """
    has_lb, has_ub, free = prob.has_lb, prob.has_ub, prob.free_mask
    sl = jnp.where(has_lb, x - prob.lb, 1.0)
    su = jnp.where(has_ub, prob.ub - x, 1.0)
    sigma = del_w + jnp.where(has_lb, zl / sl, 0.0) + jnp.where(has_ub, zu / su, 0.0)
    return jnp.where(free, sigma, 1.0)


# ---------------------------------------------------------------------------
# Factorization (with the reference's regularization-bump retry loop)
# ---------------------------------------------------------------------------


def _assemble_normal(prob: DeviceQP, sigma, del_c, factor_dtype):
    """S = A Sigma^-1 A' - del_c I with degenerate rows pinned to identity.

    Assembled directly in the *factor* dtype so the O(m^2 n) matmul runs at
    fp32 rate when factoring in fp32; the fp64 refinement operator never
    materializes S (it applies A twice instead, see solve_condensed).

    Pinned ("non-live") rows are the padded rows AND structurally empty real
    rows (all-zero A row, or nonzeros only on fixed columns): their normal
    diagonal would be exactly -del_c, which is <= 0 for the reference's
    default ``FixedRegularization(1e-10, 1e-10)`` (src/utils.jl:91) — not
    SPD.  The reference never sees this because an LP with such rows either
    goes through presolve (empty-row elimination) or errors; here the direct
    ``madipm()`` path must survive it, so dy on those rows is simply 0.
    """
    free = prob.free_mask
    dinv = jnp.where(free, 1.0 / sigma, 0.0)
    # Dense: one matmul (m,n)*(n,) @ (n,m).  Sparse: gather/segment-sum
    # assembly over the host-precomputed pattern (models/sparse.py).
    S = prob.assemble_normal_matrix(dinv, factor_dtype)
    dS = jnp.diagonal(S)
    live = prob.row_mask & (dS > 0)
    diag_add = jnp.where(live, -jnp.asarray(del_c, factor_dtype), 1.0 - dS)
    S = S + jnp.diag(diag_add)
    return S, dinv, live


#: Floor on |del_c| for the CONDENSED formulation: the equality relaxation
#: gamma = 1/|del_c| must stay finite and the SPD factor conditioned.  Plays
#: the role of MadNLP's RelaxEquality slack relaxation for its condensed KKT.
CONDENSED_RELAX_MIN = 1e-8

#: Diagonal shift added to the Jacobi-scaled matrix BEFORE a low-precision
#: factorization (only when fp64 PCG recovery is active).  The factor is
#: just a preconditioner there, so it may be regularized far more strongly
#: than the true system: with linearly dependent constraint rows (e.g.
#: transportation LPs, where supply and demand rows sum identically) the
#: scaled normal matrix is singular up to the user's del_c ~ 1e-8 — an
#: fp32 Cholesky pivot of ~1e-4 drowning in ~1e-5 accumulation noise,
#: which either NaNs (caught) or silently produces a garbage factor
#: (ERROR_IN_STEP_COMPUTATION downstream).  Shifting the PRECONDITIONER by
#: 1e-6 keeps its pivots >= 1e-3 (healthy in fp32) while the PCG operator
#: keeps the exact del_c; null-direction preconditioned eigenvalues land
#: at ~1e-2, costing at most a few extra Krylov iterations.  The reference
#: never faces this because its direct solvers factor in fp64 with
#: pivoting (cuDSS LDL / Ma57).
PRECOND_SHIFT = 1e-6


def _assemble_condensed(prob: DeviceQP, sigma, del_c, factor_dtype):
    """C = diag(sigma) + Q + gamma A'A with masked columns pinned to 1.

    K1: eliminating dy from [Sigma+Q, A'; A, del_c I][dx;dy] = [rx;rp] via
    ``dy = (rp - A dx)/del_c`` (del_c < 0 => gamma = -1/del_c > 0) gives the
    SPD size-n system above.  Structurally empty rows (see _assemble_normal)
    carry dy = 0 and are masked out of the A'A product.
    """
    dc_mag = jnp.maximum(jnp.abs(del_c), CONDENSED_RELAX_MIN)
    gamma = 1.0 / dc_mag
    live = prob.live_rows()
    # A' diag(live) A via the problem's operator (dense: one matmul;
    # sparse: pattern segment-sum, models/sparse.py); gamma folded in
    # afterwards so the squared entries stay at fp32 range (gamma ~ 1e8
    # would overflow them).
    C = prob.assemble_ata(live.astype(prob.dtype), factor_dtype)
    C = C * jnp.asarray(gamma, factor_dtype)
    C = C + jnp.diag(sigma.astype(factor_dtype))
    C = prob.add_quad(C, factor_dtype)
    # Pin non-free columns to identity rows/cols (sigma is 1 there and the
    # A'A / Q terms never touch them — both are free-masked).
    return C, gamma, live


def _assemble_augmented(prob: DeviceQP, sigma, del_c, factor_dtype):
    """K = [Sigma+Q, A'; A, del_c I], masked columns/rows pinned.

    Structurally empty rows (see _assemble_normal) are pinned to 1 like
    padded rows: with a tiny del_c their pivot would be ~0 and dy garbage.
    """
    free = prob.free_mask
    A_eff = (prob.dense_A * free[None, :]).astype(factor_dtype)
    H = jnp.diag(sigma.astype(factor_dtype))
    H = prob.add_quad(H, factor_dtype)
    live = prob.row_mask & (jnp.sum(A_eff * A_eff, axis=1) > 0)
    du = jnp.where(live, jnp.asarray(del_c, factor_dtype), 1.0)
    # live rows keep del_c (may be 0: the augmented matrix stays
    # nonsingular if A has full row rank).
    K = jnp.block([[H, A_eff.T], [A_eff, jnp.diag(du)]])
    return K, live


def factorize(cfg: KKTConfig, prob: DeviceQP, x, zl, zu, del_w, del_c,
              force_ok=None):
    """Factorize the KKT system, bumping regularization x100 on failure.

    Mirrors ``factorize_regularized_system!`` (reference:
    src/linear_solver.jl:6-17): up to ``max_factor_trials`` attempts, each
    multiplying (del_w, del_c) by 100.  Returns (factors, del_w, del_c, ok).

    ``force_ok`` (an optional traced bool) accepts the FIRST attempt
    unconditionally — the finished-lane neutralization hook: under vmap a
    converged lane still executes the loop body (while_loop batching
    select-masks it), and without this its terminal barrier system could
    drive the x100 retry loop below for every remaining trip, dragging all
    lanes through up to ``max_factor_trials`` extra factorizations.
    """
    rdtype = prob.dtype

    def _attempt_inner(dw, dc):
        sigma = build_sigma(prob, x, zl, zu, dw)
        if cfg.kind == KKTSystem.NORMAL and cfg.dist_mesh is not None:
            # Distributed path: the m x m normal matrix is assembled into
            # row strips (reduce-scatter) and panel-factored across the
            # mesh (parallel/dist_chol.py) — never replicated.  Only the
            # CHOLESKY/CHOLESKY_INV-equivalent matmul-only solve exists
            # here; flex-PCG's inner operator (full Smat) is deliberately
            # unsupported (it would re-materialize S).
            from ..parallel import dist_chol

            free = prob.free_mask
            dinv = jnp.where(free, 1.0 / sigma, 0.0)
            shift = (
                PRECOND_SHIFT
                if cfg.refinement_steps > 0 and jnp.dtype(cfg.factor_dtype) != rdtype
                else 0.0
            )
            # dinv = 0 on fixed/padded columns already masks them out of
            # the A D A' product; A itself stays untouched.
            L, W, jac, live, ok = dist_chol.dist_factor_normal(
                cfg.dist_mesh,
                prob.dense_A,
                dinv,
                prob.row_mask,
                dc,
                shift,
                cfg.factor_dtype,
                axis=cfg.dist_axis,
            )
            return (
                DistNormalFactors(
                    L=L, W=W, jac=jac, dinv=dinv,
                    del_c=jnp.asarray(dc, rdtype), live=live,
                ),
                ok,
            )
        if cfg.kind == KKTSystem.NORMAL:
            S, dinv, live = _assemble_normal(prob, sigma, dc, cfg.factor_dtype)
            # Jacobi (diagonal) scaling before the low-precision factor: the
            # IPM normal matrix's ill-conditioning is mostly diagonal, so
            # D^-1/2 S D^-1/2 keeps fp32 Cholesky + fp64 refinement
            # convergent near the barrier floor (the dense analogue of the
            # reference's K2.5 ScaledSparseKKTSystem, src/kernels.jl:138-149).
            dS = jnp.diagonal(S)
            jac = jax.lax.rsqrt(jnp.maximum(dS, jnp.finfo(cfg.factor_dtype).tiny))
            Shat = S * jac[:, None] * jac[None, :]
            Shat_raw = Shat  # pre-shift (precond_refine's correction target)
            if cfg.refinement_steps > 0 and jnp.dtype(cfg.factor_dtype) != rdtype:
                # Preconditioner-only shift (see PRECOND_SHIFT): the PCG
                # operator keeps the exact del_c.
                Shat = Shat + jnp.asarray(PRECOND_SHIFT, cfg.factor_dtype) * jnp.eye(
                    Shat.shape[-1], dtype=cfg.factor_dtype
                )
            if cfg.linear_solver == LinearSolver.CHOLESKY_INV:
                Lc, W = block_chol.chol_inv(Shat)
                ok = linalg.cholesky_is_ok(Lc) & jnp.all(jnp.isfinite(W))
                fac = W  # store the inverse factor; solves are matmuls
            else:
                fac = linalg.cholesky_factor(Shat)
                ok = linalg.cholesky_is_ok(fac)
            # Smat is only consumed by the flexible-PCG inner operator and
            # the precond_refine inner correction, both of which only
            # engage when the factor runs BELOW the residual precision; a
            # scalar dummy otherwise, so the retry while_loop does not
            # carry a dead (m,m) buffer.  Stored PRE-shift: refine corrects
            # toward the true scaled S, and flex-PCG's inner Krylov is a
            # preconditioner either way.
            need_smat = (
                cfg.use_flex_pcg or cfg.precond_refine
            ) and jnp.dtype(cfg.factor_dtype) != rdtype
            smat = Shat_raw if need_smat else jnp.zeros((), cfg.factor_dtype)
            return (
                NormalFactors(
                    L=fac, jac=jac, dinv=dinv,
                    del_c=jnp.asarray(dc, rdtype), live=live, Smat=smat,
                ),
                ok,
            )
        elif cfg.kind == KKTSystem.CONDENSED and cfg.dist_mesh is not None:
            # Distributed K1: the size-n SPD system is assembled from
            # row-sharded A blocks and strip-factored across the mesh —
            # multi-chip QPs (parallel/dist_chol.dist_factor_condensed).
            from ..parallel import dist_chol

            dc_mag = jnp.maximum(jnp.abs(dc), CONDENSED_RELAX_MIN)
            gamma = 1.0 / dc_mag
            live = prob.live_rows()
            free = prob.free_mask
            A_eff = prob.dense_A * free[None, :]
            Qd = None
            if prob.is_qp:
                Qd = prob.add_quad(
                    jnp.zeros((prob.n, prob.n), cfg.factor_dtype), cfg.factor_dtype
                )
            shift = (
                PRECOND_SHIFT
                if cfg.refinement_steps > 0 and jnp.dtype(cfg.factor_dtype) != rdtype
                else 0.0
            )
            L, W, jac, ok = dist_chol.dist_factor_condensed(
                cfg.dist_mesh, A_eff, Qd, sigma, live.astype(rdtype),
                gamma, shift, cfg.factor_dtype, axis=cfg.dist_axis,
            )
            dc_eff = -jnp.maximum(jnp.abs(jnp.asarray(dc, rdtype)), CONDENSED_RELAX_MIN)
            return (
                DistCondensedFactors(
                    L=L, W=W, jac=jac, sigma=sigma,
                    gamma=jnp.asarray(gamma, rdtype),
                    del_c=dc_eff, live=live,
                ),
                ok,
            )
        elif cfg.kind == KKTSystem.CONDENSED:
            C, gamma, live = _assemble_condensed(prob, sigma, dc, cfg.factor_dtype)
            dC = jnp.diagonal(C)
            jac = jax.lax.rsqrt(jnp.maximum(dC, jnp.finfo(cfg.factor_dtype).tiny))
            Chat = C * jac[:, None] * jac[None, :]
            if cfg.refinement_steps > 0 and jnp.dtype(cfg.factor_dtype) != rdtype:
                Chat = Chat + jnp.asarray(PRECOND_SHIFT, cfg.factor_dtype) * jnp.eye(
                    Chat.shape[-1], dtype=cfg.factor_dtype
                )
            if cfg.linear_solver == LinearSolver.CHOLESKY_INV:
                # Matmul-only inverse factor: solves are matmuls, as in NORMAL.
                Lc, W = block_chol.chol_inv(Chat)
                ok = linalg.cholesky_is_ok(Lc) & jnp.all(jnp.isfinite(W))
                fac = W
            else:
                fac = linalg.cholesky_factor(Chat)
                ok = linalg.cholesky_is_ok(fac)
            dc_eff = -jnp.maximum(jnp.abs(jnp.asarray(dc, rdtype)), CONDENSED_RELAX_MIN)
            need_smat = cfg.use_flex_pcg and jnp.dtype(cfg.factor_dtype) != rdtype
            smat = Chat if need_smat else jnp.zeros((), cfg.factor_dtype)
            return (
                CondensedFactors(
                    L=fac, jac=jac, sigma=sigma,
                    gamma=jnp.asarray(gamma, rdtype),
                    del_c=dc_eff, live=live, Smat=smat,
                ),
                ok,
            )
        else:
            K, live = _assemble_augmented(prob, sigma, dc, cfg.factor_dtype)
            if cfg.kind == KKTSystem.SCALED_AUGMENTED:
                # K2.5: symmetric |diag|^-1/2 scaling before the factor (the
                # reference's ScaledSparseKKTSystem conditioning role,
                # src/kernels.jl:138-149).  The factor holds Khat = J K J;
                # solves unscale through J (solve_condensed).
                dK = jnp.abs(jnp.diagonal(K))
                jac = jax.lax.rsqrt(jnp.maximum(dK, jnp.finfo(cfg.factor_dtype).tiny))
                K = K * jac[:, None] * jac[None, :]
            else:
                jac = jnp.ones(K.shape[-1], cfg.factor_dtype)
            if cfg.linear_solver == LinearSolver.LU:
                lu, piv = linalg.lu_factor(K)
                ok = linalg.lu_is_ok(lu)
                return (
                    AugmentedFactors(
                        Lfac=lu, dfac=piv, sigma=sigma,
                        del_c=jnp.asarray(dc, rdtype), live=live, jac=jac,
                    ),
                    ok,
                )
            elif cfg.linear_solver == LinearSolver.LDL_INV:
                L, d, W = block_chol.ldl_inv(K)
                ok = (
                    jnp.all(jnp.isfinite(d))
                    & jnp.all(d != 0)
                    & jnp.all(jnp.isfinite(W))
                )
                return (
                    AugmentedFactors(
                        Lfac=W, dfac=d, sigma=sigma,
                        del_c=jnp.asarray(dc, rdtype), live=live, jac=jac,
                    ),
                    ok,
                )
            else:  # LDL
                L, d = linalg.ldl_factor(K)
                ok = linalg.ldl_is_ok(L, d)
                return (
                    AugmentedFactors(
                        Lfac=L, dfac=d, sigma=sigma,
                        del_c=jnp.asarray(dc, rdtype), live=live, jac=jac,
                    ),
                    ok,
                )

    # Factor-precision override (see KKTConfig.factor_precision): applies to
    # the WHOLE attempt — normal/condensed/augmented assembly and the blocked
    # factorization are all factor-dtype matmuls; the fp64-critical math in
    # here (build_sigma, mask logic) is elementwise and unaffected by matmul
    # precision.  Gated to below-residual-precision factors only.
    prec = cfg.factor_precision
    if prec is not None and jnp.dtype(cfg.factor_dtype) == rdtype:
        prec = None

    def attempt(dw, dc):
        if prec is None:
            return _attempt_inner(dw, dc)
        with jax.default_matmul_precision(prec):
            return _attempt_inner(dw, dc)

    factors0, ok0 = attempt(del_w, del_c)
    if force_ok is not None:
        ok0 = ok0 | force_ok

    def cond(carry):
        trial, dw, dc, _, ok = carry
        return (~ok) & (trial < cfg.max_factor_trials)

    def body(carry):
        trial, dw, dc, _, _ = carry
        dw = dw * 100.0
        if cfg.kind in (KKTSystem.NORMAL, KKTSystem.CONDENSED):
            # SPD formulations factor S - del_c I: a non-negative del_c can
            # never rescue a singular S (e.g. linearly dependent rows), so
            # retries force the stabilizing sign.  First attempt honors the
            # user's policy exactly; the reference's retry likewise exists
            # only to strengthen regularization (src/linear_solver.jl:6-17).
            dc = -jnp.maximum(jnp.abs(dc), 1e-12) * 100.0
        else:
            dc = dc * 100.0
        f, ok = attempt(dw, dc)
        return (trial + 1, dw, dc, f, ok)

    trial, del_w, del_c, factors, ok = lax.while_loop(
        cond, body, (jnp.asarray(1), jnp.asarray(del_w, rdtype), jnp.asarray(del_c, rdtype), factors0, ok0)
    )
    return factors, del_w, del_c, ok


# ---------------------------------------------------------------------------
# Condensed solve
# ---------------------------------------------------------------------------

#: Inner (factor-precision) PCG iteration budget of the mixed-precision
#: restarted solve.  Each inner iteration costs two m×m fp32 matmuls
#: (operator + preconditioner); the inner loop exits on its own fp32 noise
#: floor anyway (pcg_lowp rtol), so the budget is a cap, not a cost.
MIXED_INNER_ITERS = 8


def _mixed_inner_solver(cfg: KKTConfig, factors):
    """Factor-precision inner solver for the restarted mixed-precision PCG.

    Returns ``inner(r) -> d`` with ``S d ≈ r`` where S is the (fp64) normal
    or condensed operator, computed ENTIRELY in the factor precision: the
    residual is normalized to unit magnitude (fp32 headroom), moved into the
    Jacobi-scaled space where ``Smat = D S D`` and its Cholesky factor live,
    solved by :func:`linalg.pcg_lowp` (fp32 matmuls only), and mapped back.

    The outer fp64 loop (:func:`linalg.pcg_flex`) keeps the Krylov
    iteration on the EXACT operator — one fp64 A-matvec pair per outer
    iteration plus the initial residual — while this inner solve does its
    Krylov work at fp32 rate.  Standard flexible-PCG construction
    (variable preconditioner, Polak–Ribière beta).
    """
    L, jac, Smat = factors.L, factors.jac, factors.Smat
    fdt = L.dtype

    if cfg.linear_solver == LinearSolver.CHOLESKY_INV:
        solve_lp = lambda b: block_chol.chol_inv_solve(L, b)
    else:
        solve_lp = lambda b: linalg.cholesky_solve(L, b)

    def matvec_lp(v):
        return jnp.dot(Smat, v, preferred_element_type=fdt)

    def inner(r):
        s = jnp.maximum(jnp.max(jnp.abs(r)), jnp.finfo(r.dtype).tiny)
        b_lp = ((r / s) * jac).astype(fdt)
        yhat = linalg.pcg_lowp(solve_lp, matvec_lp, b_lp, max_iters=MIXED_INNER_ITERS)
        return s * (jac * yhat).astype(r.dtype)

    return inner


def solve_condensed(
    cfg: KKTConfig,
    prob: DeviceQP,
    factors,
    rx,
    rp,
    pcg_budget: Optional[int] = None,
    pcg_rtol=None,
    return_products: bool = False,
):
    """Solve [Sigma+Q, A'; A, del_c][dx; dy] = [rx; rp].

    ``return_products=True`` additionally returns ``(A dx, A' dy)`` so the
    driver can advance its memoized ``A x / A' y`` pair by recurrence
    instead of recomputing it (2 of the ~8 fp64 A-applications per MPC
    iteration).  On the NORMAL fp64-PCG path both come free from solve
    byproducts: ``A' dy`` is the back-substitution's own product and
    ``A dx = rp + r_pcg - del_c*dy`` (from dx = Sigma^-1(rx - A'dy) and
    S dy = r2 - r_pcg).  ``A dx`` then carries the PCG's recursive-residual
    drift, O(eps64)/iteration — callers accumulating across iterations must
    resync periodically (the fused driver recomputes the pair exactly at
    every CERT_PERIOD chunk boundary).  Paths without a tracked residual
    (direct solves, flex PCG, K1, AUGMENTED) fall back to explicit
    products — never wrong, merely not free.

    NORMAL path mirrors the reference's condensation stack
    (src/KKT/normalkkt.jl:196-219): r2 = A Sigma^-1 rx - rp, SPD solve for
    dy, back-substitute dx = Sigma^-1 (rx - A' dy).  Low-precision factor
    solves are wrapped in fp64 iterative refinement (ops/linalg.refine),
    replacing the reference's residual check + SolveException
    (src/linear_solver.jl:28-43) with active correction.
    """
    # Factor-precision override for PRECONDITIONER applications (see
    # KKTConfig.factor_precision): every inner solve here is factor-dtype
    # matmuls sitting behind the exact fp64 Krylov operator, so they only
    # need preconditioner quality.  The fp64 operator itself (``matvec``
    # below, via prob.matvec/rmatvec) stays OUTSIDE the context.
    fprec = cfg.factor_precision
    if fprec is not None and jnp.dtype(cfg.factor_dtype) == rx.dtype:
        fprec = None

    def _with_fprec(f):
        if fprec is None:
            return f

        def g(b):
            with jax.default_matmul_precision(fprec):
                return f(b)

        return g

    if isinstance(factors, (NormalFactors, DistNormalFactors)):
        live = factors.live
        dinv = factors.dinv
        r1 = dinv * rx
        r2 = prob.matvec(r1) - rp
        r2 = jnp.where(live, r2, 0.0)

        jac = factors.jac
        r_pcg = None  # PCG residual byproduct (return_products fast path)

        if isinstance(factors, DistNormalFactors):
            from ..parallel import dist_chol

            def solve_fn(b):
                # Distributed preconditioner application: strip-sharded
                # forward/backward substitution (matmul-only local work +
                # small psums; parallel/dist_chol.dist_chol_solve).
                bf = (b * jac).astype(factors.L.dtype)
                y = dist_chol.dist_chol_solve(
                    cfg.dist_mesh, factors.L, factors.W, bf, cfg.dist_axis
                )
                return y * jac
        else:
            refine_inner = cfg.precond_refine and factors.Smat.ndim == 2

            def solve_fn(b):
                # Preconditioned low-precision solve through the Jacobi scaling:
                # S = D^1/2 Shat D^1/2  =>  S^-1 b = D^-1/2 Shat^-1 D^-1/2 b
                bf = (b * jac).astype(factors.L.dtype)
                if cfg.linear_solver == LinearSolver.CHOLESKY_INV:
                    base = lambda v: block_chol.chol_inv_solve(factors.L, v)
                else:
                    base = lambda v: linalg.cholesky_solve(factors.L, v)
                z = base(bf)
                if refine_inner:
                    # Second-order preconditioner (KKTConfig.precond_refine):
                    # one correction against the retained UNSHIFTED scaled S
                    # cancels the PRECOND_SHIFT's λ/(λ+σ) mis-scaling of
                    # weak directions — an fp32 matvec + factor apply,
                    # ~2 orders cheaper than the fp64 pair each saved PCG
                    # iteration avoids.
                    z = z + base(bf - factors.Smat @ z)
                return z * jac

        solve_fn = _with_fprec(solve_fn)

        def matvec(v):
            # Exact fp64 operator applied via A twice — S itself is only
            # ever materialized in the factor dtype.
            sv = prob.matvec(dinv * prob.rmatvec(v)) - factors.del_c * v
            return jnp.where(live, sv, v)

        if cfg.refinement_steps > 0:
            # ``pcg_rtol`` (a traced scalar) overrides the exit tolerance —
            # the inexact-Newton hook: early IPM iterations tolerate step
            # residuals proportional to mu (driver passes a mu-scaled
            # tolerance when opt.pcg_adaptive_tol is on).
            if pcg_budget == 0:
                # Preconditioner-only solve: apply the (fp32) factor and
                # skip the fp64 PCG altogether — no operator application,
                # no residual check.  Used for the PREDICTOR when
                # predictor_pcg_budget=0: the affine direction only feeds
                # centering heuristics that need a few digits.
                dy = solve_fn(r2).astype(r2.dtype)
                dy = jnp.where(live, dy, 0.0)
                atdy = prob.rmatvec(dy)
                dx = dinv * (rx - atdy)
                if return_products:
                    return dx, dy, jnp.where(live, prob.matvec(dx), 0.0), atdy
                return dx, dy
            mixed = (
                cfg.use_flex_pcg
                and factors.L.dtype != r2.dtype
                and isinstance(factors, NormalFactors)  # dist has no Smat
            )
            if mixed:
                # Flexible PCG with the fp32 inner CG as preconditioner:
                # outer Krylov stays on the EXACT fp64 operator (robust past
                # the fp32 conditioning ceiling near the barrier floor),
                # while each preconditioner application runs several Krylov
                # iterations at fp32 rate on the retained Jacobi-scaled
                # S.  Well-conditioned solves exit after the first
                # application (one fp64 A-pair total); hard ones converge
                # like the classic fp64 PCG this generalizes.
                inner = _mixed_inner_solver(cfg, factors)
                if pcg_budget is not None:  # predictor: reduced budget
                    rt = 1e-12 if pcg_rtol is None else pcg_rtol
                    dy = linalg.pcg_flex(inner, matvec, r2, max_iters=pcg_budget, rtol=rt)
                else:  # corrector: full accuracy
                    rt = 1e-14 if pcg_rtol is None else pcg_rtol
                    dy = linalg.pcg_flex(
                        inner, matvec, r2, max_iters=4 * cfg.refinement_steps, rtol=rt
                    )
            elif pcg_budget is not None:
                rt = 1e-12 if pcg_rtol is None else pcg_rtol
                out = linalg.pcg(
                    solve_fn, matvec, r2, max_iters=pcg_budget, rtol=rt,
                    return_residual=return_products,
                )
                dy, r_pcg = out if return_products else (out, None)
            else:
                rt = 1e-14 if pcg_rtol is None else pcg_rtol
                out = linalg.pcg(
                    solve_fn, matvec, r2, max_iters=4 * cfg.refinement_steps,
                    rtol=rt, return_residual=return_products,
                )
                dy, r_pcg = out if return_products else (out, None)
        else:
            dy = solve_fn(r2).astype(r2.dtype)
        dy = jnp.where(live, dy, 0.0)

        atdy = prob.rmatvec(dy)
        dx = dinv * (rx - atdy)
        if return_products:
            if r_pcg is not None:
                adx = jnp.where(live, rp + r_pcg - factors.del_c * dy, 0.0)
            else:
                # direct/flex paths: no tracked residual — explicit product
                adx = jnp.where(live, prob.matvec(dx), 0.0)
            return dx, dy, adx, atdy
        return dx, dy
    elif isinstance(factors, (CondensedFactors, DistCondensedFactors)):
        # K1: (Sigma + Q + gamma A'A) dx = rx + gamma A' rp, then recover
        # dy = -gamma (rp - A dx) (sign: del_c = -1/gamma < 0).
        free = prob.free_mask
        live = factors.live
        gamma = factors.gamma
        rp_l = jnp.where(live, rp, 0.0)
        rhs = jnp.where(free, rx + gamma * prob.rmatvec(rp_l), 0.0)

        jac = factors.jac

        if isinstance(factors, DistCondensedFactors):
            from ..parallel import dist_chol

            def solve_fn(b):
                bf = (b * jac).astype(factors.L.dtype)
                y = dist_chol.dist_chol_solve(
                    cfg.dist_mesh, factors.L, factors.W, bf, cfg.dist_axis
                )
                return y * jac
        else:
            def solve_fn(b):
                bf = (b * jac).astype(factors.L.dtype)
                if cfg.linear_solver == LinearSolver.CHOLESKY_INV:
                    return block_chol.chol_inv_solve(factors.L, bf) * jac
                return linalg.cholesky_solve(factors.L, bf) * jac

        solve_fn = _with_fprec(solve_fn)

        def matvec(v):
            vx = jnp.where(free, v, 0.0)
            cv = factors.sigma * vx + gamma * prob.rmatvec(
                jnp.where(live, prob.matvec(vx), 0.0)
            )
            if prob.is_qp:
                cv = cv + prob.qmatvec(vx)
            return jnp.where(free, cv, v)

        if cfg.refinement_steps > 0 and pcg_budget == 0:
            # Preconditioner-only (see the NORMAL branch note).
            dx = solve_fn(rhs).astype(rhs.dtype)
            dx = jnp.where(free, dx, 0.0)
            adx = prob.matvec(dx)
            dy = jnp.where(live, -gamma * (rp - adx), 0.0)
            if return_products:
                return dx, dy, jnp.where(live, adx, 0.0), prob.rmatvec(dy)
            return dx, dy
        if cfg.refinement_steps > 0:
            rt = 1e-14 if pcg_rtol is None else pcg_rtol
            iters = (
                pcg_budget if pcg_budget is not None else 4 * cfg.refinement_steps
            )
            if (
                cfg.use_flex_pcg
                and factors.L.dtype != rhs.dtype
                and isinstance(factors, CondensedFactors)  # dist has no Smat
            ):
                # Flexible PCG with the fp32 inner CG preconditioner (see
                # the NORMAL branch).  K1 with an fp64 factor (the default:
                # gamma ~ 1e8 exceeds fp32 dynamic range) keeps the all-fp64
                # PCG below.
                inner = _mixed_inner_solver(cfg, factors)
                dx = linalg.pcg_flex(inner, matvec, rhs, max_iters=iters, rtol=rt)
            else:
                dx = linalg.pcg(solve_fn, matvec, rhs, max_iters=iters, rtol=rt)
        else:
            dx = solve_fn(rhs).astype(rhs.dtype)
        dx = jnp.where(free, dx, 0.0)
        adx = prob.matvec(dx)
        dy = jnp.where(live, -gamma * (rp - adx), 0.0)
        if return_products:
            # A dx comes free from the dy recovery; A' dy costs one extra
            # half-pair — still cheaper than the driver's full memo pair.
            return dx, dy, jnp.where(live, adx, 0.0), prob.rmatvec(dy)
        return dx, dy
    else:
        n = prob.n
        free = prob.free_mask
        live = factors.live
        rhs = jnp.concatenate(
            [jnp.where(free, rx, 0.0), jnp.where(live, rp, 0.0)]
        )
        # K2.5 scaling: K = J^-1 Khat J^-1 with the factor holding Khat,
        # so K^-1 b = J Khat^-1 J b (jac == ones for plain K2).
        jac = factors.jac

        if cfg.linear_solver == LinearSolver.LU:
            raw = lambda b: linalg.lu_solve(
                factors.Lfac, factors.dfac, b.astype(factors.Lfac.dtype)
            )
        elif cfg.linear_solver == LinearSolver.LDL_INV:
            raw = lambda b: block_chol.ldl_inv_solve(
                factors.Lfac, factors.dfac, b.astype(factors.Lfac.dtype)
            )
        else:
            raw = lambda b: linalg.ldl_solve(
                factors.Lfac, factors.dfac, b.astype(factors.Lfac.dtype)
            )
        solve_fn = _with_fprec(lambda b: (jac * raw((b * jac))).astype(rx.dtype))

        def matvec(v):
            # Exact fp64 augmented operator from the original pieces.
            vx, vy = v[:n], v[n:]
            hx = factors.sigma * vx
            if prob.is_qp:
                hx = hx + prob.qmatvec(jnp.where(free, vx, 0.0))
            ax = prob.matvec(jnp.where(free, vx, 0.0))
            aty = prob.rmatvec(jnp.where(live, vy, 0.0))
            top = jnp.where(free, hx + aty, vx)
            bot = jnp.where(live, ax + factors.del_c * vy, vy)
            return jnp.concatenate([top, bot])

        sol = linalg.refine(solve_fn, matvec, rhs, cfg.refinement_steps)
        dx = jnp.where(free, sol[:n], 0.0)
        dy = jnp.where(live, sol[n:], 0.0)
        if return_products:
            return (
                dx, dy,
                jnp.where(live, prob.matvec(dx), 0.0), prob.rmatvec(dy),
            )
        return dx, dy


# ---------------------------------------------------------------------------
# Solve residual check (reference solve_system! residual check,
# src/linear_solver.jl:28-43)
# ---------------------------------------------------------------------------


def solve_residual(prob: DeviceQP, factors, rx, rp, dx, dy):
    """||K d - r||_inf / max(1, ||r||_inf) of the (regularized) KKT solve.

    The reference computes this after every direct solve and throws a
    SolveException when it exceeds ``tol_linear_solve``
    (src/linear_solver.jl:28-43); here refinement/PCG already drives the
    residual down actively, so the check (enabled with
    ``check_residual=True``) is a guardrail that flags
    ERROR_IN_STEP_COMPUTATION instead of silently stepping on garbage.

    Evaluated on the *condensed* system: top block
    ``Sigma dx + A' dy - rx`` (the Q term is folded into Sigma only for
    the NORMAL/LP path; the AUGMENTED path adds it explicitly) and bottom
    block ``A dx + del_c dy - rp``, masked to live rows/free columns.
    """
    free = prob.free_mask
    dt = rx.dtype
    if isinstance(factors, NormalFactors):
        sigma = jnp.where(free, 1.0 / jnp.where(factors.dinv == 0, 1.0, factors.dinv), 1.0)
        hx = jnp.where(factors.dinv == 0, 0.0, sigma * dx)
        qx = prob.qmatvec(jnp.where(free, dx, 0.0)) if prob.is_qp else 0.0
        top = jnp.where(free, hx + qx + prob.rmatvec(dy) - rx, 0.0)
        bot = jnp.where(
            factors.live,
            prob.matvec(jnp.where(free, dx, 0.0)) + factors.del_c * dy - rp,
            0.0,
        )
    else:
        hx = factors.sigma * dx
        if prob.is_qp:
            hx = hx + prob.qmatvec(jnp.where(free, dx, 0.0))
        top = jnp.where(free, hx + prob.rmatvec(jnp.where(factors.live, dy, 0.0)) - rx, 0.0)
        bot = jnp.where(
            factors.live,
            prob.matvec(jnp.where(free, dx, 0.0)) + factors.del_c * dy - rp,
            0.0,
        )
    num = jnp.maximum(jnp.max(jnp.abs(top)), jnp.max(jnp.abs(bot)))
    den = jnp.maximum(
        1.0, jnp.maximum(jnp.max(jnp.abs(rx * free)), jnp.max(jnp.abs(rp * prob.row_mask)))
    )
    return num / den
