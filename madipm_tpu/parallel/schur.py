"""Distributed single-instance KKT: column-partitioned Schur assembly.

New capability vs the single-device reference (SURVEY §2.3, §7 step 7): one
large LP's KKT solve distributed over the device mesh.  The variable
dimension (columns of A, all n-vectors) is sharded; the normal matrix

    S = A Sigma^-1 A' = sum_k A_k D_k A_k'        (k = device shard)

is a sum of per-device outer products reduced with ``psum`` — the
communication-optimal decomposition (one m x m all-reduce per iteration,
independent of n).  The factorization of S then runs replicated (every device
factors the same m x m matrix) unless the distributed strip Cholesky
(parallel/dist_chol.py) is selected.

Two entry points:

- :func:`shard_columns` + :func:`solve_sharded` — GSPMD route: annotate the
  shardings and let XLA insert the collectives into the *unchanged* solver
  program (the "pick a mesh, annotate, let XLA do it" recipe).
- :func:`schur_normal_solve` — explicit ``shard_map`` building block with
  hand-placed ``psum`` for the Schur reduction, used by tests to pin down
  the communication pattern.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..models.qp import DeviceQP
from ..solver import driver


def shard_columns(prob: DeviceQP, mesh: Mesh, axis: str = "cols") -> DeviceQP:
    """Place a DeviceQP with the variable dimension sharded over ``axis``.

    A: [m, n] -> P(None, axis); n-vectors -> P(axis); m-vectors replicated.
    Requires n divisible by the mesh axis size (pad_to_device guarantees
    lane-multiple padding; choose pad_multiple = 128 * mesh size for safety).
    """
    col = NamedSharding(mesh, P(axis))
    row = NamedSharding(mesh, P())
    mat = NamedSharding(mesh, P(None, axis))
    put = jax.device_put
    return dataclasses.replace(
        prob,
        A=put(prob.A, mat),
        c=put(prob.c, col),
        lb=put(prob.lb, col),
        ub=put(prob.ub, col),
        col_mask=put(prob.col_mask, col),
        x0=put(prob.x0, col),
        b=put(prob.b, row),
        row_mask=put(prob.row_mask, row),
        y0=put(prob.y0, row),
        # Q row-sharded: matches the dist-K1 strip layout (a P(axis, axis)
        # spec is illegal — one mesh axis cannot shard two dimensions).
        Q=None if prob.Q is None else put(prob.Q, NamedSharding(mesh, P(axis, None))),
    )


def solve_sharded(
    cfg: driver.SolverConfig,
    prob: DeviceQP,
    mesh: Mesh,
    axis: str = "cols",
    distribute_factor: bool = True,
):
    """Run the standard solve with column shardings; XLA inserts the
    psum/all-gather collectives for the S assembly and A'y products.

    ``distribute_factor=True`` (default, NORMAL KKT) additionally routes
    the per-iteration factorization through the distributed strip Cholesky
    (parallel/dist_chol.dist_factor_normal): the m x m factor itself is
    partitioned across the mesh instead of replicated on every device —
    SURVEY §7 step 7, and the lever for m x m factors that exceed one
    device's memory.  Requires m divisible by the mesh axis size.
    """
    from ..utils.options import KKTSystem

    if distribute_factor and cfg.kkt.kind == KKTSystem.NORMAL:
        cfg = dataclasses.replace(
            cfg,
            kkt=dataclasses.replace(cfg.kkt, dist_mesh=mesh, dist_axis=axis),
        )
    prob = shard_columns(prob, mesh, axis)
    fn = jax.jit(partial(driver.solve_device, cfg))
    return fn(prob)


# ---------------------------------------------------------------------------
# Explicit shard_map Schur kernel
# ---------------------------------------------------------------------------


def schur_normal_solve(mesh: Mesh, A, dinv, rx, rp, row_mask, del_c, axis: str = "cols"):
    """Solve (A Sigma^-1 A' - del_c) dy = A Sigma^-1 rx - rp and
    back-substitute dx, with columns of A sharded over ``axis``.

    Per-device: local partial Schur product + psum; replicated Cholesky.
    Mirrors ops/kkt.py NORMAL semantics (padded rows pinned to identity).
    """

    def local(A_k, dinv_k, rx_k, rp_, row_mask_):
        # Local partial normal matrix and rhs contribution.
        S_part = jnp.dot(A_k * dinv_k[None, :], A_k.T, preferred_element_type=A_k.dtype)
        r_part = jnp.dot(A_k, dinv_k * rx_k, preferred_element_type=A_k.dtype)
        S = lax.psum(S_part, axis)  # the one m x m all-reduce per solve
        r = lax.psum(r_part, axis)
        diag_add = jnp.where(row_mask_, -del_c, 1.0 - jnp.diagonal(S))
        S = S + jnp.diag(diag_add)
        r2 = jnp.where(row_mask_, r - rp_, 0.0)
        L = jnp.linalg.cholesky(S)
        z = lax.linalg.triangular_solve(L, r2[:, None], left_side=True, lower=True)
        dy = lax.linalg.triangular_solve(
            L, z, left_side=True, lower=True, transpose_a=True
        )[:, 0]
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
