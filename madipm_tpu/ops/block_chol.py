"""Recursive blocked Cholesky with explicit inverse factor.

Matmul-only alternative to the reference's sparse direct solver role (cuDSS
CHOLESKY, README.md:87-98): instead of factor + sequential triangular
solves, compute the *inverse* Cholesky factor ``Linv = L^-1`` by a statically-unrolled
divide-and-conquer recursion of pure matmuls:

    S = [[S11, S21'], [S21, S22]]
    L11 = chol(S11)                      (recurse)
    W1  = L11^-1                         (from recursion)
    L21 = S21 W1'
    L22 = chol(S22 - L21 L21')           (recurse)
    Linv = [[W1, 0], [-W2 L21 W1, W2]]   (W2 = L22^-1)

Every op above is a matmul on power-of-two tiles; the base case is a tiny
masked Gaussian elimination.  Solves become two matmuls:
``x = Linv' (Linv b)``, so the per-IPM-iteration predictor/corrector solves
(reference: src/KKT/normalkkt.jl:196-219 triangular solves) cost two
matvecs each.  Selected by ``LinearSolver.CHOLESKY_INV`` / ``LDL_INV``; the
default route is ``jnp.linalg.cholesky`` + triangular solves
(ops/linalg.py).  Stability is recovered by the fp64 iterative-refinement
wrapper (ops/linalg.refine) around the fp32 factor.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

_BASE = 16  # base-case size for the unrolled elimination


def _tri_inv_base(L):
    """Invert a lower-triangular block by Neumann doubling — pure matmuls.

    Write L = D (I - N) with D = diag(L) and N strictly lower (nilpotent,
    N^s = 0).  Then (I - N)^-1 = sum N^i, computed exactly by repeated
    doubling: S_{m+1} = (I + R_m) S_m with R_{m+1} = R_m^2, R_0 = N — only
    2*ceil(log2 s) matmuls and no sequential substitution loops (a forward
    substitution would cost O(s^2) sequential steps).  Exact in exact
    arithmetic; used on small/diagonal blocks where the conditioning is
    mild.
    """
    s = L.shape[-1]
    if s == 1:
        return 1.0 / L
    eye = jnp.eye(s, dtype=L.dtype)
    d = jnp.sum(L * eye, axis=1)
    N = eye - L / d[:, None]  # strictly lower
    S = eye + N
    R = N
    steps = max(0, (s - 1).bit_length() - 1)
    for _ in range(steps):
        R = jnp.matmul(R, R)
        S = S + jnp.matmul(R, S)
    return S / d[None, :]


def _chol_base(S):
    """Unblocked Cholesky of a small tile via masked Gaussian elimination.

    Returns (L, Linv).  NaNs propagate on non-SPD input (failure signal,
    like jnp.linalg.cholesky).  Unrolled (s is a small static size), so
    each step is kept to a few ops: columns stay (s,1) and the factor is
    accumulated by one-hot outer products.  A 1-D slice-and-stack form
    lowers ``chol_inv`` at 512 to ~40% more HLO.
    """
    s = S.shape[-1]
    if s == 1:
        L = jnp.sqrt(S)
        return L, 1.0 / L
    rows_c = lax.broadcasted_iota(jnp.int32, (s, 1), 0)  # (s,1)
    cols_r = lax.broadcasted_iota(jnp.int32, (1, s), 1)  # (1,s)
    M = S
    L = jnp.zeros_like(S)
    for j in range(s):
        dinv = lax.rsqrt(M[j : j + 1, j : j + 1])  # (1,1)
        col = jnp.where(rows_c >= j, M[:, j : j + 1] * dinv, 0.0)  # (s,1)
        onehot = (cols_r == j).astype(S.dtype)  # (1,s)
        L = L + jnp.matmul(col, onehot)
        M = M - jnp.matmul(col, col.T)
    return L, _tri_inv_base(L)


def chol_inv(S: jax.Array, base: int = _BASE):
    """(L, Linv) of SPD S via the matmul recursion.  S must be square with
    power-of-two-friendly size (callers pad to lane multiples anyway)."""
    n = S.shape[-1]
    if n <= base or n % 2 != 0:
        return _chol_base(S)
    h = n // 2
    S11 = S[..., :h, :h]
    S21 = S[..., h:, :h]
    S22 = S[..., h:, h:]
    L11, W1 = chol_inv(S11, base)
    L21 = jnp.matmul(S21, W1.mT if hasattr(W1, "mT") else W1.T)
    # L21 = S21 W1' ; trailing Schur complement
    T = S22 - jnp.matmul(L21, L21.mT if hasattr(L21, "mT") else L21.T)
    L22, W2 = chol_inv(T, base)
    Z = jnp.zeros_like(S21.mT if hasattr(S21, "mT") else S21.T)
    W21 = -jnp.matmul(W2, jnp.matmul(L21, W1))
    L = jnp.block([[L11, Z], [L21, L22]])
    W = jnp.block([[W1, Z], [W21, W2]])
    return L, W


def _ldl_base(S):
    """Unpivoted LDL' of a small tile: returns (L unit-lower, d, Linv)."""
    s = S.shape[-1]
    rows = jnp.arange(s, dtype=jnp.int32)
    M = S
    cols = []
    ds = []
    for j in range(s):
        dj = M[j, j]
        l = jnp.where(rows > j, M[:, j] / dj, 0.0)
        cf = jnp.where(rows == j, 1.0, l)
        M = M - dj * cf[:, None] * cf[None, :]
        cols.append(cf)
        ds.append(dj)
    L = jnp.stack(cols, axis=1)
    d = jnp.stack(ds)
    return L, d, _tri_inv_base(L)


def ldl_inv(S: jax.Array, base: int = _BASE):
    """(L, d, Linv) of a symmetric quasi-definite S via the matmul recursion.

    Unpivoted LDL' — valid for IPM-regularized augmented matrices
    [Sigma+Q, A'; A, -delta] (symmetric quasi-definite => strongly
    factorizable, Vanderbei).  Like :func:`chol_inv`, every op is a matmul
    on static tiles, so solves are two matmuls + a diagonal scale (no
    lax.linalg).
    Replaces the reference's cuDSS ``MadNLP.LDL`` (scripts/benchmarks_gpu.jl:42).
    """
    n = S.shape[-1]
    if n <= base or n % 2 != 0:
        return _ldl_base(S)
    h = n // 2
    S11 = S[..., :h, :h]
    S21 = S[..., h:, :h]
    S22 = S[..., h:, h:]
    L11, d1, W1 = ldl_inv(S11, base)
    L21 = jnp.matmul(S21, W1.T) / d1[None, :]
    T = S22 - jnp.matmul(L21 * d1[None, :], L21.T)
    L22, d2, W2 = ldl_inv(T, base)
    Z = jnp.zeros_like(S21.T)
    W21 = -jnp.matmul(W2, jnp.matmul(L21, W1))
    L = jnp.block([[L11, Z], [L21, L22]])
    W = jnp.block([[W1, Z], [W21, W2]])
    d = jnp.concatenate([d1, d2])
    return L, d, W


def ldl_inv_solve(Linv: jax.Array, d: jax.Array, b: jax.Array) -> jax.Array:
    """Solve S x = b given Linv = L^-1 and d: x = Linv' diag(1/d) Linv b."""
    y = jnp.einsum("...ij,...j->...i", Linv, b) / d
    return jnp.einsum("...ji,...j->...i", Linv, y)


def chol_inv_solve(Linv: jax.Array, b: jax.Array) -> jax.Array:
    """Solve S x = b given Linv = L^-1: x = Linv' Linv b — two matmuls."""
    if b.ndim == Linv.ndim - 1:
        y = jnp.einsum("...ij,...j->...i", Linv, b)
        return jnp.einsum("...ji,...j->...i", Linv, y)
    y = jnp.matmul(Linv, b)
    return jnp.matmul(Linv.mT if hasattr(Linv, "mT") else Linv.T, y)
