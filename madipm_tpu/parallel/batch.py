"""Batched (vmapped + sharded) solves.

Batched replacement for the reference's *serial* benchmark sweeps
(reference: scripts/benchmarks_cpu.jl:15-58 loops over instances one at a
time): instances padded to a common bucket shape are stacked on a leading
axis, the whole solve is ``vmap``-ed (XLA batches every factorization and
matvec; on the GPU the Cholesky is cuSOLVER's batched potrf) and the batch
axis is sharded across the device mesh — each device solves its shard, no
communication needed (pure data parallelism).

``vmap`` of ``lax.while_loop`` runs until every instance terminates, with
per-instance updates masked out once an instance's status leaves REGULAR —
the padded-bucket analogue of per-instance early exit.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import List, Optional, Sequence, Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.qp import DeviceQP, QuadraticModel, pad_to_device, slack_form
from ..solver import driver
from ..solver.state import IPMState
from ..utils.options import IPMOptions, load_options
from ..utils.stats import IPMStats
from ..utils.status import Status


def stack_problems(probs: Sequence[DeviceQP]) -> DeviceQP:
    """Stack same-shape DeviceQPs along a new leading batch axis."""
    shapes = {(p.m, p.n, p.is_qp) for p in probs}
    if len(shapes) != 1:
        raise ValueError(f"all problems must share a padded shape, got {shapes}")
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *probs)


def bucket_pad(models: Sequence[QuadraticModel], pad_multiple: int = 128, dtype=jnp.float64):
    """Slack-form + pad a set of models to one common bucket shape."""
    slacked = [slack_form(m) for m in models]
    m_pad = max(pad_multiple, *(int(np.ceil(s.ncon / pad_multiple)) * pad_multiple for s in slacked))
    n_pad = max(pad_multiple, *(int(np.ceil(s.nvar / pad_multiple)) * pad_multiple for s in slacked))
    probs = [pad_to_device(s, dtype=dtype, m_pad=m_pad, n_pad=n_pad) for s in slacked]
    return stack_problems(probs), slacked


def bucket_pad_sparse(
    models: Sequence[QuadraticModel], pad_multiple: int = 128, dtype=jnp.float64
):
    """Slack-form + pad a set of sparse LPs/QPs to one common ELL bucket
    shape.

    Different sparsity patterns share padded ELL lane widths and pattern
    lengths; padded slots are marked with out-of-range indices the device
    assembly drops (models/sparse.pad_sparse_to_device padding contract).

    A bucket containing any QP is packed for the K1 CONDENSED system
    (the sparse-QP formulation); LP members carry an explicit zero Q so
    every instance shares one pytree shape."""
    from ..models.qp import _round_up
    from ..models.sparse import pad_sparse_to_device

    slacked = [slack_form(m) for m in models]
    any_qp = any(s.is_qp for s in slacked)
    kkt = "condensed" if any_qp else "normal"
    m_pad = max(pad_multiple, *(_round_up(s.ncon, pad_multiple) for s in slacked))
    n_pad = max(pad_multiple, *(_round_up(s.nvar, pad_multiple) for s in slacked))
    # Two-pass: build each at its natural sizes, then rebuild at the maxima.
    first = [
        pad_sparse_to_device(s, dtype=dtype, m_pad=m_pad, n_pad=n_pad, kkt=kkt)
        for s in slacked
    ]
    ell_k = max(p.A_val.shape[1] for p in first)
    ell_kt = max(p.AT_val.shape[1] for p in first)
    sizes = dict(ell_k=ell_k, ell_kt=ell_kt)
    if kkt == "normal":
        sizes.update(
            pattern_p=max(p.pair_a.shape[0] for p in first),
            pattern_nnzs=max(p.s_low.shape[0] for p in first),
        )
    else:
        sizes.update(
            cpattern_p=max(p.cpair_a.shape[0] for p in first),
            cpattern_nnzs=max(p.c_low.shape[0] for p in first),
            ell_kq=max(
                (p.Q_val.shape[1] for p in first if p.Q_val is not None), default=8
            ),
        )
    probs = [
        pad_sparse_to_device(s, dtype=dtype, m_pad=m_pad, n_pad=n_pad, kkt=kkt, **sizes)
        for s in slacked
    ]
    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *probs)
    return stacked, slacked


def solve_batched(
    cfg: driver.SolverConfig,
    probs: DeviceQP,
    mesh: Optional[Mesh] = None,
    axis: str = "batch",
):
    """Solve a stacked batch of problems; returns (prob_scaled, scale, state)
    pytrees with a leading batch dimension.

    With ``mesh``, the batch axis is sharded across devices (data parallel);
    the per-device program is identical to the single-instance solve.
    """
    fn = jax.vmap(partial(driver.solve_device, cfg))
    if mesh is not None:
        # The batch dimension must divide the mesh axis for an even shard;
        # short batches are padded by REPLICATING instance 0 (a solved
        # duplicate costs nothing extra: every lane runs the same program,
        # wall time is the max over lanes) and the pad lanes dropped.
        nsh = mesh.shape[axis]
        k = jax.tree_util.tree_leaves(probs)[0].shape[0]
        k_pad = -(-k // nsh) * nsh
        if k_pad != k:
            probs = jax.tree_util.tree_map(
                lambda a: jnp.concatenate(
                    [a, jnp.repeat(a[:1], k_pad - k, axis=0)], axis=0
                ),
                probs,
            )
        sharding = NamedSharding(mesh, P(axis))
        probs = jax.device_put(probs, sharding)
        fn = jax.jit(fn, in_shardings=(sharding,), out_shardings=sharding)
        out = fn(probs)
        if k_pad != k:
            out = jax.tree_util.tree_map(lambda a: a[:k], out)
        return out
    return jax.jit(fn)(probs)


def batched_stats(
    models: Sequence[QuadraticModel],
    scale,
    state: IPMState,
    solver_time: float,
) -> List[IPMStats]:
    """Unpack a batched solve into per-instance IPMStats."""
    out = []
    for i, model in enumerate(models):
        osc = float(scale.obj_scale[i])
        m0, n0 = model.ncon, model.nvar
        x = np.asarray(state.x[i])[:n0]
        csc = np.asarray(scale.con_scale[i])[:m0]
        out.append(
            IPMStats(
                status=Status(int(state.status[i])),
                objective=float(state.obj_val[i]) / osc,
                solution=x,
                constraints=model.cons(x),
                multipliers=np.asarray(state.y[i])[:m0] * csc / osc,
                multipliers_L=np.asarray(state.zl[i])[:n0] / osc,
                multipliers_U=np.asarray(state.zu[i])[:n0] / osc,
                iter=int(state.k[i]),
                primal_feas=float(state.inf_pr[i]),
                dual_feas=float(state.inf_du[i]),
                complementarity=float(state.inf_compl[i]),
                total_time=solver_time,
                solver_time=solver_time,
            )
        )
    return out


def madipm_batch(
    models: Sequence[QuadraticModel],
    mesh: Optional[Mesh] = None,
    pad_multiple: int = 128,
    dtype=jnp.float64,
    sparse: bool = False,
    **options,
) -> List[IPMStats]:
    """Solve many LP/QP instances in one sharded, vmapped device program.

    ``sparse=True`` uses the ELL sparse Jacobian bucket; a bucket with any
    QP goes through the K1 CONDENSED system (models/sparse.py)."""
    import dataclasses as _dc
    import time as _time

    from ..api import _ensure_x64
    from ..utils.options import KKTSystem

    _ensure_x64()
    opt = load_options(**options)
    if sparse:
        probs, slacked = bucket_pad_sparse(models, pad_multiple=pad_multiple, dtype=dtype)
    else:
        probs, slacked = bucket_pad(models, pad_multiple=pad_multiple, dtype=dtype)
    is_qp = probs.is_qp
    if sparse and is_qp:
        if opt.kkt_system is None:
            opt = _dc.replace(opt, kkt_system=KKTSystem.CONDENSED)
        elif opt.kkt_system != KKTSystem.CONDENSED:
            raise ValueError(
                f"sparse QP buckets require kkt_system=CONDENSED, got {opt.kkt_system}"
            )
    cfg = driver.make_config(opt, is_qp=is_qp, dtype=dtype)
    t0 = _time.time()
    _, scale, state = solve_batched(cfg, probs, mesh=mesh)
    state = jax.tree_util.tree_map(lambda a: a.block_until_ready(), state)
    wall = _time.time() - t0
    return batched_stats(models, scale, state, wall)
