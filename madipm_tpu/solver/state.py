"""Solver state pytree.

The JAX replacement for the reference's mutable mega-struct
``MPCSolver`` (reference: src/structure.jl:1-178).  Instead of a struct of
vectors + SubVector views mutated in place, the iterate is an immutable
NamedTuple of full-length arrays + scalars; it is carried through
``lax.while_loop`` so the entire solve stays inside one XLA program.  The
reference's index-set views (x_lr, zl_r, ... src/structure.jl:146-153)
become boolean masks on full vectors (models/qp.py: has_lb/has_ub/free).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..utils.status import Status


class IPMState(NamedTuple):
    # Primal-dual iterate (full length, masked invariants: zl=0 off has_lb,
    # zu=0 off has_ub, x pinned on fixed/padded columns)
    x: jax.Array  # [n]
    y: jax.Array  # [m]
    zl: jax.Array  # [n]
    zu: jax.Array  # [n]

    # Working bounds: start as the (relaxed) problem bounds and are nudged
    # outward by adjust_boundary whenever an iterate numerically touches them
    # (MadNLP.adjust_boundary! in apply_step!, reference src/solver.jl:313).
    lb: jax.Array  # [n]
    ub: jax.Array  # [n]

    # Search direction (kept for printing ||d|| and cross-phase reuse)
    dx: jax.Array  # [n]
    dy: jax.Array  # [m]
    dzl: jax.Array  # [n]
    dzu: jax.Array  # [n]

    # Barrier / step / regularization scalars
    mu: jax.Array  # barrier parameter for the corrector rhs
    mu_curr: jax.Array  # current average complementarity (reference solver.mu_curr)
    alpha_p: jax.Array
    alpha_d: jax.Array
    del_w: jax.Array  # active primal regularization (reference solver.del_w)
    del_c: jax.Array  # active dual regularization (reference solver.del_c)
    reg_p: jax.Array  # AdaptiveRegularization persistent delta_p
    reg_d: jax.Array  # AdaptiveRegularization persistent delta_d

    # Convergence diagnostics
    obj_val: jax.Array  # scaled objective (like reference solver.obj_val)
    inf_pr: jax.Array
    inf_du: jax.Array
    inf_compl: jax.Array
    best_compl: jax.Array  # reference solver.best_complementarity
    norm_b: jax.Array  # ||rhs||_inf at init (reference solver.norm_b)
    norm_c: jax.Array  # ||grad||_inf at init (reference solver.norm_c)

    # Counters / status
    k: jax.Array  # iteration count, int32
    status: jax.Array  # Status value, int32
    # Diagnostics of the last linear solve (residual ratio; feeds
    # check_residual semantics, reference src/linear_solver.jl:28-43)
    lin_resid: jax.Array
    # Consecutive iterations inside acceptable_tol (MadNLP acceptable-level
    # exit semantics the reference inherits; SURVEY §2.4 status machinery)
    n_acceptable: jax.Array  # int32
    # Primal-stall tracking for the infeasibility-by-stall exit
    # (driver.update_termination): best scaled inf_pr seen, and the count
    # of consecutive iterations without >=1% improvement on it.
    best_pr: jax.Array
    n_stall: jax.Array  # int32
    # Least-squares infeasibility certificate at the (periodically
    # re-evaluated) iterate: required before the stall classifier may
    # declare INFEASIBLE (kernels.ls_infeasibility_certificate).
    ls_cert: jax.Array  # bool


def init_state(n: int, m: int, dtype=jnp.float64) -> IPMState:
    z = lambda *s: jnp.zeros(s, dtype)
    sc = lambda v=0.0: jnp.asarray(v, dtype)
    return IPMState(
        x=z(n), y=z(m), zl=z(n), zu=z(n),
        lb=z(n), ub=z(n),
        dx=z(n), dy=z(m), dzl=z(n), dzu=z(n),
        mu=sc(1e-1), mu_curr=sc(0.0),
        alpha_p=sc(0.0), alpha_d=sc(0.0),
        del_w=sc(0.0), del_c=sc(0.0), reg_p=sc(0.0), reg_d=sc(0.0),
        obj_val=sc(0.0), inf_pr=sc(jnp.inf), inf_du=sc(jnp.inf),
        inf_compl=sc(jnp.inf), best_compl=sc(jnp.finfo(dtype).max),
        norm_b=sc(0.0), norm_c=sc(0.0),
        k=jnp.asarray(0, jnp.int32),
        status=jnp.asarray(int(Status.INITIAL), jnp.int32),
        lin_resid=sc(0.0),
        n_acceptable=jnp.asarray(0, jnp.int32),
        best_pr=sc(jnp.finfo(dtype).max),
        n_stall=jnp.asarray(0, jnp.int32),
        ls_cert=jnp.asarray(False),
    )
