"""Dense factorization/solve primitives.

Dense replacement for the reference's pluggable sparse direct solvers
(cuDSS / Ma57 / CHOLMOD / LDLFactorizations / LAPACK; reference:
src/linear_solver.jl, src/utils.jl:54-62).  For the KKT sizes in the
reference benchmark protocol the factorization is *dense*: on the GPU
``jnp.linalg.cholesky`` is cuSOLVER's potrf (batched under vmap) and the
triangular solves are cuBLAS trsm.  Sparsity is exploited upstream
(host-side reductions, normal-equation condensation n->m), not inside the
factorization.

Provides:
- Cholesky factor/solve for the SPD normal matrix (reference analogue:
  cuDSS CHOLESKY algorithm, README.md:87-98),
- unpivoted LDL' for quasi-definite augmented systems (reference analogue:
  cuDSS LDL, scripts/benchmarks_gpu.jl:42) — valid without pivoting because
  the regularized IPM KKT matrix is symmetric quasi-definite (Vanderbei),
- LU with partial pivoting as a robust fallback,
- mixed-precision iterative refinement (factor in fp32, residuals in
  fp64) replacing the reference's residual check in solve_system!
  (src/linear_solver.jl:28-43).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax


# ---------------------------------------------------------------------------
# Cholesky
# ---------------------------------------------------------------------------


def cholesky_factor(S: jax.Array, dtype=None):
    """Lower Cholesky factor of SPD ``S``; NaNs signal a failed factorization.

    ``jnp.linalg.cholesky`` lowers to LAPACK potrf on the CPU and cuSOLVER
    potrf on the GPU; both turn a nonzero ``info`` into an all-NaN factor,
    which :func:`cholesky_is_ok` detects.
    """
    if dtype is not None:
        S = S.astype(dtype)
    return jnp.linalg.cholesky(S)


def cholesky_is_ok(L: jax.Array) -> jax.Array:
    """True iff the factorization succeeded (finite, positive diagonal)."""
    d = jnp.diagonal(L, axis1=-2, axis2=-1)
    return jnp.all(jnp.isfinite(d) & (d > 0), axis=-1)


def cholesky_solve(L: jax.Array, b: jax.Array) -> jax.Array:
    """Solve S x = b given S = L L'."""
    b2 = b[..., None] if b.ndim == L.ndim - 1 else b
    b2 = b2.astype(L.dtype)
    y = lax.linalg.triangular_solve(L, b2, left_side=True, lower=True)
    x = lax.linalg.triangular_solve(L, y, left_side=True, lower=True, transpose_a=True)
    return x[..., 0] if b.ndim == L.ndim - 1 else x


# ---------------------------------------------------------------------------
# Unpivoted blocked LDL' (quasi-definite K2 systems)
# ---------------------------------------------------------------------------


def ldl_factor(K: jax.Array, block: int = 128, dtype=None):
    """Unpivoted LDL' factorization of a symmetric quasi-definite matrix.

    Returns (L, d) with K = L diag(d) L', L unit lower triangular.  No
    pivoting: safe for IPM-regularized augmented matrices
    [Sigma+Q, A'; A, -delta] which are symmetric quasi-definite — every
    symmetric permutation admits a (indefinite-diagonal) LDL' factorization.
    This replaces the reference's cuDSS ``MadNLP.LDL`` algorithm
    (scripts/benchmarks_gpu.jl:41-42).

    Right-looking blocked algorithm; the O(n^3) trailing updates are matmuls
    (dot_general).
    """
    if dtype is not None:
        K = K.astype(dtype)
    n = K.shape[-1]
    nb = -(-n // block)
    npad = nb * block
    if npad != n:
        # Pad with identity so padded pivots are 1 and decouple.
        Kp = jnp.zeros(K.shape[:-2] + (npad, npad), K.dtype)
        Kp = Kp.at[..., :n, :n].set(K)
        idx = jnp.arange(n, npad)
        Kp = Kp.at[..., idx, idx].set(1.0)
        K = Kp

    def unblocked_ldl(Akk):
        """LDL' of one diagonal block via elementwise Gaussian elimination."""
        b = Akk.shape[-1]
        rng = jnp.arange(b)

        def body(j, M):
            dj = M[j, j]
            col = jnp.where(rng > j, M[:, j] / dj, 0.0)
            M = M - col[:, None] * jnp.where(rng > j, M[j, :], 0.0)[None, :]
            M = M.at[:, j].set(jnp.where(rng > j, col, M[:, j]))
            return M

        M = lax.fori_loop(0, b, body, Akk)
        d = jnp.diagonal(M)
        L = jnp.tril(M, -1) + jnp.eye(b, dtype=M.dtype)
        return L, d

    # Right-looking blocked sweep; block offsets are static so plain slicing
    # keeps XLA happy (fully unrolled: nb is small for KKT sizes).
    A = K
    Lblocks = []
    dparts = []
    for k in range(nb):
        j0, j1 = k * block, (k + 1) * block
        Lkk, dk = unblocked_ldl(A[j0:j1, j0:j1])
        panel = A[j1:, j0:j1]  # (npad - j1, block)
        # L_panel = panel (Lkk')^-1 diag(1/dk)
        Lpanel = lax.linalg.triangular_solve(
            Lkk, panel, left_side=False, lower=True, transpose_a=True
        ) / dk[None, :]
        # Trailing update: A22 -= Lpanel diag(dk) Lpanel'
        if j1 < npad:
            W = Lpanel * dk[None, :]
            A = A.at[j1:, j1:].add(
                -jnp.dot(W, Lpanel.T, preferred_element_type=A.dtype)
            )
        Lblocks.append((Lkk, Lpanel))
        dparts.append(dk)

    L = jnp.zeros((npad, npad), dtype=A.dtype)
    for k, (Lkk, Lpanel) in enumerate(Lblocks):
        j0, j1 = k * block, (k + 1) * block
        L = L.at[j0:j1, j0:j1].set(Lkk)
        if j1 < npad:
            L = L.at[j1:, j0:j1].set(Lpanel)
    d = jnp.concatenate(dparts)
    if npad != n:
        L = L[:n, :n]
        d = d[:n]
    return L, d


def ldl_is_ok(L: jax.Array, d: jax.Array) -> jax.Array:
    return jnp.all(jnp.isfinite(d) & (d != 0)) & jnp.all(jnp.isfinite(L))


def ldl_solve(L: jax.Array, d: jax.Array, b: jax.Array) -> jax.Array:
    b2 = b[..., None] if b.ndim == L.ndim - 1 else b
    b2 = b2.astype(L.dtype)
    y = lax.linalg.triangular_solve(L, b2, left_side=True, lower=True, unit_diagonal=True)
    y = y / d[..., :, None]
    x = lax.linalg.triangular_solve(
        L, y, left_side=True, lower=True, transpose_a=True, unit_diagonal=True
    )
    return x[..., 0] if b.ndim == L.ndim - 1 else x


# ---------------------------------------------------------------------------
# LU fallback
# ---------------------------------------------------------------------------


def lu_factor(K: jax.Array, dtype=None):
    if dtype is not None:
        K = K.astype(dtype)
    lu, piv = jax.scipy.linalg.lu_factor(K)
    return lu, piv


def lu_is_ok(lu) -> jax.Array:
    d = jnp.diagonal(lu, axis1=-2, axis2=-1)
    return jnp.all(jnp.isfinite(d) & (d != 0))


def lu_solve(lu, piv, b: jax.Array) -> jax.Array:
    return jax.scipy.linalg.lu_solve((lu, piv.astype(jnp.int32)), b.astype(lu.dtype))


# ---------------------------------------------------------------------------
# Mixed-precision iterative refinement
# ---------------------------------------------------------------------------


def refine(
    solve_fn,
    matvec_fn,
    rhs: jax.Array,
    steps: int,
    rtol: float = 1e-14,
    min_reduction: float = None,
) -> jax.Array:
    """Iteratively refined solve: x <- x + solve(rhs - K x).

    ``solve_fn`` runs in the (possibly low) factorization precision;
    ``matvec_fn`` must evaluate K @ x in the precision of ``rhs`` (fp64).
    With a well-regularized fp32 factor, 2-3 sweeps recover ~1e-10 relative
    residuals — this is what lets fp32 arithmetic do the O(n^3) work while the
    solver converges to the reference's 1e-8 tolerance
    (SURVEY §7 "hard parts" item 4).

    ``steps`` bounds a ``while_loop`` that exits early once the residual
    stops improving or falls under ``rtol * ||rhs||``; hard systems use the
    full budget, easy ones exit after one sweep.  Divergent corrections
    (worse residual) are rejected, keeping the best iterate — the active
    replacement for the reference's residual check + SolveException
    (src/linear_solver.jl:28-43).

    ``min_reduction``, if set, adds a stall exit: a sweep that fails to
    shrink the residual by at least that factor ends the loop.  Essential
    when each sweep is expensive (one fp64 matvec pair) and the inner solve
    has a precision floor — burning the remaining budget re-confirming the
    floor costs a full fp64 operator application per sweep.
    """
    x0 = solve_fn(rhs).astype(rhs.dtype)
    if steps <= 0:
        return x0
    norm_rhs = jnp.max(jnp.abs(rhs))
    tol = rtol * jnp.maximum(1.0, norm_rhs)

    r0 = rhs - matvec_fn(x0)
    rn0 = jnp.max(jnp.abs(r0))

    def cond(carry):
        i, _x, _r, rn, go = carry
        return (i < steps) & (rn > tol) & go

    def body(carry):
        # The residual rides in the carry so each sweep costs ONE fp64
        # matvec (correction solve reuses it; the norm reads it).
        i, x, r, rn, go = carry
        x_new = x + solve_fn(r).astype(rhs.dtype)
        r_new = rhs - matvec_fn(x_new)
        rn_new = jnp.max(jnp.abs(r_new))
        # Keep the best iterate; a single non-improving sweep (rounding
        # noise near the attainable floor) doesn't end the loop unless a
        # stall exit was requested.
        improved = rn_new < rn
        x = jnp.where(improved, x_new, x)
        r = jnp.where(improved, r_new, r)
        if min_reduction is not None:
            go = rn_new < min_reduction * rn
        return (i + 1, x, r, jnp.minimum(rn_new, rn), go)

    _, x, _, _, _ = lax.while_loop(
        cond, body, (0, x0, r0, rn0, jnp.asarray(True))
    )
    return x


def pcg_lowp(solve_fn, matvec_fn, b: jax.Array, max_iters: int, rtol: float = 2e-6) -> jax.Array:
    """Preconditioned CG entirely in the *low* (factor) precision.

    The inner engine of the mixed-precision restarted solve (see
    ``ops/kkt.solve_condensed``): every operand — operator application,
    preconditioner solve, dot products — stays in fp32, so one iteration
    costs two m×m fp32 matmuls instead of an fp64 A-matvec pair.
    ``rtol`` defaults just above the fp32 noise floor: pushing further down
    cannot improve the true residual, only the outer fp64 restart can.

    Caller must pass ``b`` pre-scaled to unit magnitude (fp32 headroom).
    Same breakdown protection as :func:`pcg`: best iterate wins, non-finite
    recurrences exit on it.
    """
    x0 = solve_fn(b)
    r0 = b - matvec_fn(x0)
    z0 = solve_fn(r0)
    rn0 = jnp.max(jnp.abs(r0))
    tol = jnp.asarray(rtol, b.dtype) * jnp.maximum(1.0, jnp.max(jnp.abs(b)))

    def cond(c):
        i, _x, r, _z, _p, _rz, _bx, brn = c
        return (i < max_iters) & (jnp.max(jnp.abs(r)) > tol) & (brn > tol)

    def body(c):
        i, x, r, z, p, rz, best_x, best_rn = c
        Ap = matvec_fn(p)
        pAp = jnp.dot(p, Ap)
        alpha = rz / jnp.where(pAp != 0, pAp, 1.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = solve_fn(r)
        rz_new = jnp.dot(r, z)
        beta = rz_new / jnp.where(rz != 0, rz, 1.0)
        p = z + beta * p
        rn = jnp.max(jnp.abs(r))
        better = (rn < best_rn) & jnp.all(jnp.isfinite(x))
        best_x = jnp.where(better, x, best_x)
        best_rn = jnp.where(better, rn, best_rn)
        bad = ~jnp.all(jnp.isfinite(r))
        x = jnp.where(bad, best_x, x)
        r = jnp.where(bad, jnp.zeros_like(r), r)
        return (i + 1, x, r, z, p, rz_new, best_x, best_rn)

    init = (0, x0, r0, z0, z0, jnp.dot(r0, z0), x0, rn0)
    _, _, _, _, _, _, best_x, _ = lax.while_loop(cond, body, init)
    return best_x


def pcg_flex(precond_fn, matvec_fn, rhs: jax.Array, max_iters: int, rtol: float = 1e-14) -> jax.Array:
    """Flexible PCG in fp64 with a *variable* (inner-iterative) preconditioner.

    The mixed-precision workhorse: ``matvec_fn`` applies the EXACT fp64
    operator (so convergence survives cond(S) past the fp32 ceiling — the
    property plain restarted refinement loses), while ``precond_fn`` may be
    an inner fp32 PCG (:func:`pcg_lowp`) whose output varies between
    applications.  Flexibility = Polak–Ribière beta
    ``z_{k+1}'(r_{k+1} − r_k)/(z_k' r_k)`` instead of Fletcher–Reeves, the
    standard fix for non-constant preconditioners (Notay, "Flexible CG").

    Early/mid IPM iterations: the inner solve is so strong the first
    application already meets tolerance — total cost ONE fp64 operator
    application (the residual check).  Late ill-conditioned iterations: the
    inner fp32 CG degenerates to its own best iterate (≈ the factor solve)
    and this reduces to the classic fp64 PCG that is known to converge.
    """
    norm_rhs = jnp.max(jnp.abs(rhs))
    tol = rtol * jnp.maximum(1.0, norm_rhs)

    x0 = precond_fn(rhs).astype(rhs.dtype)
    r0 = rhs - matvec_fn(x0)
    rn0 = jnp.max(jnp.abs(r0))

    def make_z(r):
        return precond_fn(r).astype(rhs.dtype)

    z0 = make_z(r0)

    def cond(c):
        i, _x, r, _z, _p, _rz, _bx, brn = c
        return (i < max_iters) & (jnp.max(jnp.abs(r)) > tol) & (brn > tol)

    def body(c):
        i, x, r, z, p, rz, best_x, best_rn = c
        Ap = matvec_fn(p)
        pAp = jnp.dot(p, Ap)
        alpha = rz / jnp.where(pAp != 0, pAp, 1.0)
        x = x + alpha * p
        r_new = r - alpha * Ap
        z_new = make_z(r_new)
        # Polak–Ribière: immune to the preconditioner changing between
        # applications (Fletcher–Reeves z'r would lose conjugacy).
        rz_new = jnp.dot(r_new, z_new)
        beta = jnp.dot(z_new, r_new - r) / jnp.where(rz != 0, rz, 1.0)
        p = z_new + beta * p
        rn = jnp.max(jnp.abs(r_new))
        better = (rn < best_rn) & jnp.all(jnp.isfinite(x))
        best_x = jnp.where(better, x, best_x)
        best_rn = jnp.where(better, rn, best_rn)
        bad = ~jnp.all(jnp.isfinite(r_new))
        x = jnp.where(bad, best_x, x)
        r_new = jnp.where(bad, jnp.zeros_like(r_new), r_new)
        return (i + 1, x, r_new, z_new, p, rz_new, best_x, best_rn)

    init = (0, x0, r0, z0, z0, jnp.dot(r0, z0), x0, rn0)
    _, _, _, _, _, _, best_x, _ = lax.while_loop(cond, body, init)
    return best_x


def pcg(solve_fn, matvec_fn, rhs: jax.Array, max_iters: int, rtol: float = 1e-14,
        return_residual: bool = False) -> jax.Array:
    """Preconditioned conjugate gradient in fp64 with a low-precision factor
    as preconditioner.

    Strictly stronger than iterative refinement (Richardson) for SPD systems:
    where refinement diverges once eps32 * cond(S) > 1, PCG still converges
    as long as the preconditioned operator stays positive definite — this is
    what carries the fp32 factorization through the ill-conditioned
    final IPM iterations (cond(S) ~ 1/mu^2) to the 1e-8 tolerance.

    ``solve_fn`` applies the preconditioner (fp32 Cholesky solve);
    ``matvec_fn`` applies the exact fp64 operator.  Falls back gracefully:
    the iterate with the smallest residual seen is returned.

    ``return_residual=True`` additionally returns the residual VECTOR
    ``rhs - matvec_fn(best_x)`` tracked alongside ``best_x`` — by CG's
    recursive update, so it drifts from the true residual by O(eps64) per
    iteration.  Consumers that accumulate it across outer iterations (the
    driver's A x / A' y recurrence) must resync periodically.
    """
    norm_rhs = jnp.max(jnp.abs(rhs))
    tol = rtol * jnp.maximum(1.0, norm_rhs)

    x0 = solve_fn(rhs).astype(rhs.dtype)
    r0 = rhs - matvec_fn(x0)
    z0 = solve_fn(r0).astype(rhs.dtype)
    rn0 = jnp.max(jnp.abs(r0))

    def cond(c):
        i, _x, r, _z, _p, _rz, _bx, _br, brn = c
        return (i < max_iters) & (jnp.max(jnp.abs(r)) > tol) & (brn > tol)

    def body(c):
        i, x, r, z, p, rz, best_x, best_r, best_rn = c
        Ap = matvec_fn(p)
        pAp = jnp.dot(p, Ap)
        alpha = rz / jnp.where(pAp != 0, pAp, 1.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = solve_fn(r).astype(rhs.dtype)
        rz_new = jnp.dot(r, z)
        beta = rz_new / jnp.where(rz != 0, rz, 1.0)
        p = z + beta * p
        rn = jnp.max(jnp.abs(r))
        better = (rn < best_rn) & jnp.all(jnp.isfinite(x))
        best_x = jnp.where(better, x, best_x)
        best_r = jnp.where(better, r, best_r)
        best_rn = jnp.where(better, rn, best_rn)
        # Breakdown protection: a non-finite recurrence ends the loop on the
        # best iterate seen (r=0 exits `cond`; best_x is what's returned).
        # Done with masking, NOT a recovery matvec — a `where` with a
        # matvec_fn(best_x) operand would evaluate that matvec every
        # iteration (XLA has no short-circuit), doubling the dominant
        # fp64-operator cost of the whole PCG.
        bad = ~jnp.all(jnp.isfinite(r))
        x = jnp.where(bad, best_x, x)
        r = jnp.where(bad, jnp.zeros_like(r), r)
        return (i + 1, x, r, z, p, rz_new, best_x, best_r, best_rn)

    init = (0, x0, r0, z0, z0, jnp.dot(r0, z0), x0, r0, rn0)
    _, _, _, _, _, _, best_x, best_r, _ = lax.while_loop(cond, body, init)
    if return_residual:
        return best_x, best_r
    return best_x
