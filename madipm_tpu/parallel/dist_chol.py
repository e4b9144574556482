"""Distributed blocked Cholesky over a mesh axis (shard_map + collectives).

SURVEY §7 step 7 / "hard part #2": the reference is single-device, its
factorization a cuDSS call; here a single large SPD system's factorization
itself is partitioned over devices.  Row-strip layout: device ``p`` of ``P``
owns rows ``[p·mb, (p+1)·mb)`` (mb = m / P) of the matrix and of the factor.

Right-looking panel algorithm, one panel per device-strip:

    for k in 0..P-1:
        D    = psum(owner-k's diagonal block)            # [mb, mb]
        W    = chol(D)^-1          (replicated — cheaper than broadcasting)
        B_p  = strip_p[:, kcols] @ W.T                   # local panel block
        panel = all_gather(B_p)                          # [m, mb]
        strip_p[:, trailing] -= B_p @ panel.T            # local matmul update

Per panel: one [mb,mb] psum + one [m,mb] all_gather; total communication
O(m²) words — the same order as gathering S once, but peak per-device
memory stays m·mb and every trailing update is a local matmul.  The
owner's panel block needs no special case: D @ W.T = Lkk Lkk' Lkk⁻ᵀ = Lkk.

The diagonal block is factored by ``jnp.linalg.cholesky`` and inverted by
one triangular solve against the identity (cuSOLVER potrf + cuBLAS trsm on
the GPU).  The panel loop is unrolled, so each panel's block factorization
is a separate op in the program: a library call keeps that program small,
where the matmul-only recursion (ops/block_chol) would unroll into
thousands of ops per panel and take minutes to compile at mb = 1024.

Solves use the per-device inverse diagonal blocks (saved at factor time),
so forward/backward substitution is P small psums of [mb] vectors with
matmul-only local work — no ``lax.linalg.triangular_solve``, whose
sequential sweep would have to run across the strips.

Numerical contract matches ops/linalg.cholesky (no pivoting; caller owns
regularization retries).  Validated against ``jnp.linalg.cholesky`` on an
8-fake-device CPU mesh in tests/test_parallel.py.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..ops import linalg


def _local_cholesky(mesh: Mesh, axis: str, S_p):
    """shard_map body: S_p is the local row strip [mb, m]."""
    p = lax.axis_index(axis)
    nshards = lax.axis_size(axis)
    mb = S_p.shape[0]
    m = S_p.shape[1]
    rows_g = p * mb + jnp.arange(mb)  # global row ids of this strip
    cols_g = jnp.arange(m)

    L_p = S_p
    W_own = jnp.zeros((mb, mb), S_p.dtype)
    for k in range(m // mb):
        kcols = slice(k * mb, (k + 1) * mb)
        # Diagonal block from its owner (psum of a masked strip slice).
        own = (p == k).astype(S_p.dtype)
        D = lax.psum(L_p[:, kcols] * own, axis)
        # Replicated factor + inverse of the mb x mb block, no broadcast
        # round needed; a failed factor is all-NaN and poisons W.
        Lkk = linalg.cholesky_factor(D)
        W = lax.linalg.triangular_solve(
            Lkk, jnp.eye(mb, dtype=D.dtype), left_side=True, lower=True
        )
        W_own = jnp.where(p == k, W, W_own)
        # Panel block of this strip; rows above the panel are zero in L.
        B_p = jnp.dot(L_p[:, kcols], W.T, preferred_element_type=S_p.dtype)
        B_p = jnp.where(rows_g[:, None] >= k * mb, B_p, 0.0)
        # Full panel [m, mb] on every device (the one big collective).
        panel = lax.all_gather(B_p, axis, tiled=True)
        # Trailing update on the local strip, then write the panel column.
        trailing = cols_g >= (k + 1) * mb
        upd = jnp.dot(B_p, panel.T, preferred_element_type=S_p.dtype)
        L_p = jnp.where(trailing[None, :], L_p - upd, L_p)
        L_p = jnp.concatenate([L_p[:, : k * mb], B_p, L_p[:, (k + 1) * mb :]], axis=1)
    # Zero the strictly-upper part (trailing columns of each strip).
    L_p = jnp.where(cols_g[None, :] <= rows_g[:, None], L_p, 0.0)
    return L_p, W_own


def dist_cholesky(mesh: Mesh, S, axis: str = "cols"):
    """Factor SPD ``S`` (m x m, m divisible by the axis size) into the
    row-strip-sharded lower factor L plus per-device inverse diagonal
    blocks W (for the matmul-only solves)."""
    fn = shard_map(
        partial(_local_cholesky, mesh, axis),
        mesh=mesh,
        in_specs=P(axis, None),
        out_specs=(P(axis, None), P(axis, None)),
    )
    return fn(S)


def _local_solve(mesh: Mesh, axis: str, L_p, W_p, b):
    """Forward + backward substitution; b replicated [m], result replicated."""
    p = lax.axis_index(axis)
    mb = L_p.shape[0]
    m = L_p.shape[1]
    nblk = m // mb
    rows_g = p * mb + jnp.arange(mb)
    cols_g = jnp.arange(m)

    # Forward: y = L^-1 b, one block per step (owner computes, psum shares).
    y = jnp.zeros_like(b)
    for k in range(nblk):
        # r = b_k - L[k strip, :k*mb] @ y[:k*mb]  (mask instead of slicing
        # keeps shapes static; y is zero beyond solved blocks anyway).
        done = cols_g < k * mb
        r = b[k * mb : (k + 1) * mb] - jnp.dot(
            jnp.where(done[None, :], L_p, 0.0), y, preferred_element_type=b.dtype
        )
        y_k = lax.psum(jnp.where(p == k, jnp.dot(W_p, r), 0.0), axis)
        y = lax.dynamic_update_slice(y, y_k, (k * mb,))

    # Backward: x = L^-T y.  sum_{j>k} L_jk' x_j is a psum of local
    # strip-column products (device j holds L_jk in its strip).
    x = jnp.zeros_like(b)
    for k in range(nblk - 1, -1, -1):
        below = rows_g >= (k + 1) * mb
        x_strip = lax.dynamic_slice(x, (p * mb,), (mb,))
        t = lax.psum(
            jnp.dot(
                L_p[:, k * mb : (k + 1) * mb].T,
                jnp.where(below, x_strip, 0.0),
                preferred_element_type=b.dtype,
            ),
            axis,
        )
        r = y[k * mb : (k + 1) * mb] - t
        x_k = lax.psum(jnp.where(p == k, jnp.dot(W_p.T, r), 0.0), axis)
        x = lax.dynamic_update_slice(x, x_k, (k * mb,))
    return x


def dist_chol_solve(mesh: Mesh, L, W, b, axis: str = "cols"):
    """Solve L L' x = b given the sharded factor from :func:`dist_cholesky`.
    ``b`` replicated; returns x replicated."""
    fn = shard_map(
        partial(_local_solve, mesh, axis),
        mesh=mesh,
        in_specs=(P(axis, None), P(axis, None), P()),
        out_specs=P(),
    )
    return fn(L, W, b)


def dist_factor_normal(
    mesh: Mesh, A, dinv, row_mask, del_c, shift, factor_dtype, axis: str = "cols"
):
    """Distributed NORMAL-KKT factorization: column-sharded Schur assembly
    reduce-scattered into row strips + in-place distributed Cholesky.

    Reproduces ops/kkt._assemble_normal + the Jacobi scaling + the
    PRECOND_SHIFT semantics of the replicated fp32 factor path, with the
    m x m matrix never materialized on one device:

        S_strip = psum_scatter(A_k D_k A_k')     [mb, m] per device
        live/diag pinning + Jacobi D^-1/2 S D^-1/2 + shift
        L, W = _local_cholesky(strips)           (panel all_gathers)

    Returns (L, W, jac, live, ok): L/W row-strip-sharded over ``axis``,
    jac/live replicated, ok a replicated scalar for the regularization
    retry loop (ops/kkt.factorize).
    """
    fdt = jnp.dtype(factor_dtype)

    def local(A_k, dinv_k, row_mask_):
        p = lax.axis_index(axis)
        nshards = lax.axis_size(axis)
        m = A_k.shape[0]
        mb = m // nshards
        Af = A_k.astype(fdt)
        df = dinv_k.astype(fdt)
        S_part = jnp.dot(Af * df[None, :], Af.T, preferred_element_type=fdt)
        # Reduce-scatter: each device keeps only the row strip it factors
        # (half the all-reduce traffic of a full psum).
        S_strip = lax.psum_scatter(S_part, axis, scatter_dimension=0, tiled=True)
        rows_g = p * mb + jnp.arange(mb)
        dS_strip = S_strip[jnp.arange(mb), rows_g]
        dS = lax.all_gather(dS_strip, axis, tiled=True)  # [m] replicated
        live = row_mask_ & (dS > 0)
        diag_add = jnp.where(live, -jnp.asarray(del_c, fdt), 1.0 - dS)
        S_strip = S_strip.at[jnp.arange(mb), rows_g].add(
            lax.dynamic_slice(diag_add, (p * mb,), (mb,))
        )
        d_new = dS + diag_add
        jac = lax.rsqrt(jnp.maximum(d_new, jnp.finfo(fdt).tiny))  # [m] replicated
        jac_strip = lax.dynamic_slice(jac, (p * mb,), (mb,))
        Shat = S_strip * jac_strip[:, None] * jac[None, :]
        if shift:
            Shat = Shat.at[jnp.arange(mb), rows_g].add(jnp.asarray(shift, fdt))
        L_p, W_p = _local_cholesky(mesh, axis, Shat)
        diag_L = L_p[jnp.arange(mb), rows_g]
        ok_local = (
            jnp.all(jnp.isfinite(L_p))
            & jnp.all(jnp.isfinite(W_p))
            & jnp.all(diag_L > 0)
        )
        ok = lax.psum(ok_local.astype(jnp.int32), axis) == nshards
        return L_p, W_p, jac, live, ok

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(None, axis), P(axis), P(None)),
        out_specs=(P(axis, None), P(axis, None), P(None), P(None), P()),
        # jac/live/ok ARE replicated (derived from all_gather/psum results
        # and replicated inputs), but the static vma checker cannot infer it
        # through the closed-over del_c/shift scalars; replication is pinned
        # numerically by tests/test_parallel.py::TestIntegratedDistFactor.
        check_vma=False,
    )
    return fn(A, dinv, row_mask)


def dist_factor_condensed(
    mesh: Mesh, A_eff, Qd, sigma, live, gamma, shift, factor_dtype,
    axis: str = "cols",
):
    """Distributed K1 (CONDENSED) factorization — multi-chip QPs.

    Assembles ``C = diag(sigma) + Q + gamma * A' diag(live) A`` (the SPD
    size-n system of ops/kkt._assemble_condensed) with A ROW-sharded over
    the mesh axis: each device forms its partial ``gamma * A_p' L_p A_p``
    ([n, n]) from its row block, a reduce-scatter lands the row STRIPS of
    C on their factoring devices, Q/sigma strips are added locally, and
    the same panel Cholesky as the NORMAL path factors in place.  C and
    its factor are never materialized on one device.

    ``A_eff`` must already be free-column-masked (caller passes
    ``A * free``), ``Qd`` the free-masked dense Hessian (or None for an
    LP), ``live`` the live-row indicator.  Returns (L, W, jac, ok) with
    L/W row-strip-sharded, jac replicated.  Reference capability: GPU QP
    solves via cuDSS (test/test_gpu.jl:9-21), here spread over a mesh.
    """
    fdt = jnp.dtype(factor_dtype)
    n = A_eff.shape[1]

    def local(A_p, live_p, Q_p, sigma_):
        p = lax.axis_index(axis)
        nshards = lax.axis_size(axis)
        nb = n // nshards
        Af = A_p.astype(fdt) * live_p.astype(fdt)[:, None]
        C_part = jnp.dot(Af.T, A_p.astype(fdt), preferred_element_type=fdt)
        C_part = C_part * jnp.asarray(gamma, fdt)
        C_strip = lax.psum_scatter(C_part, axis, scatter_dimension=0, tiled=True)
        if Q_p is not None:
            C_strip = C_strip + Q_p.astype(fdt)
        rows_g = p * nb + jnp.arange(nb)
        sig_strip = lax.dynamic_slice(sigma_.astype(fdt), (p * nb,), (nb,))
        C_strip = C_strip.at[jnp.arange(nb), rows_g].add(sig_strip)
        dC_strip = C_strip[jnp.arange(nb), rows_g]
        dC = lax.all_gather(dC_strip, axis, tiled=True)  # [n] replicated
        jac = lax.rsqrt(jnp.maximum(dC, jnp.finfo(fdt).tiny))
        jac_strip = lax.dynamic_slice(jac, (p * nb,), (nb,))
        Chat = C_strip * jac_strip[:, None] * jac[None, :]
        if shift:
            Chat = Chat.at[jnp.arange(nb), rows_g].add(jnp.asarray(shift, fdt))
        L_p, W_p = _local_cholesky(mesh, axis, Chat)
        diag_L = L_p[jnp.arange(nb), rows_g]
        ok_local = (
            jnp.all(jnp.isfinite(L_p))
            & jnp.all(jnp.isfinite(W_p))
            & jnp.all(diag_L > 0)
        )
        ok = lax.psum(ok_local.astype(jnp.int32), axis) == nshards
        return L_p, W_p, jac, ok

    in_specs = (P(axis, None), P(axis), P(axis, None) if Qd is not None else P(), P(None))
    if Qd is None:
        # shard_map requires array args; thread a scalar placeholder.
        def local2(A_p, live_p, _z, sigma_):
            return local(A_p, live_p, None, sigma_)

        fn = shard_map(
            local2, mesh=mesh,
            in_specs=in_specs,
            out_specs=(P(axis, None), P(axis, None), P(None), P()),
            check_vma=False,
        )
        return fn(A_eff, live, jnp.zeros(()), sigma)
    fn = shard_map(
        local, mesh=mesh,
        in_specs=in_specs,
        out_specs=(P(axis, None), P(axis, None), P(None), P()),
        check_vma=False,
    )
    return fn(A_eff, live, Qd, sigma)


def schur_normal_solve_dist(
    mesh: Mesh, A, dinv, rx, rp, row_mask, del_c, axis: str = "cols"
):
    """Column-sharded Schur assembly (parallel/schur.py semantics) with the
    m x m factorization ALSO distributed: assembly psums the partial
    normal matrices into row strips, dist_cholesky factors in place, and
    the back-substitution reuses the column shards.

    Requires m divisible by the axis size (pad_to_device guarantees
    lane-multiple padding; pick pad_multiple = 128 * mesh size).
    """

    def local(A_k, dinv_k, rx_k, rp_, row_mask_):
        p = lax.axis_index(axis)
        nshards = lax.axis_size(axis)
        m = A_k.shape[0]
        mb = m // nshards
        # Partial normal matrix; reduce-scatter to row strips (each device
        # keeps only the rows it will factor — half the all-reduce traffic).
        S_part = jnp.dot(A_k * dinv_k[None, :], A_k.T, preferred_element_type=A_k.dtype)
        S_strip = lax.psum_scatter(S_part, axis, scatter_dimension=0, tiled=True)
        r = lax.psum(
            jnp.dot(A_k, dinv_k * rx_k, preferred_element_type=A_k.dtype), axis
        )
        rows_g = p * mb + jnp.arange(mb)
        mask_strip = lax.dynamic_slice(row_mask_, (p * mb,), (mb,))
        dS = S_strip[jnp.arange(mb), rows_g]
        diag_add = jnp.where(mask_strip, -del_c, 1.0 - dS)
        S_strip = S_strip.at[jnp.arange(mb), rows_g].add(diag_add)
        r2 = jnp.where(row_mask_, r - rp_, 0.0)

        L_p, W_p = _local_cholesky(mesh, axis, S_strip)
        dy = _local_solve(mesh, axis, L_p, W_p, r2)
        dy = jnp.where(row_mask_, dy, 0.0)
        dx_k = dinv_k * (rx_k - jnp.dot(A_k.T, dy, preferred_element_type=A_k.dtype))
        return dx_k, dy

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(None, axis), P(axis), P(axis), P(None), P(None)),
        out_specs=(P(axis), P(None)),
    )
    return fn(A, dinv, rx, rp, row_mask)
