"""Top-level solver API.

``madipm(model, **options)`` — the JAX analogue of the reference's
``madipm(m; kwargs...)`` entry point (reference: src/solver.jl:420-428):
construct the solver from a problem model, run the Mehrotra
predictor-corrector loop, and return execution statistics.

Pipeline (mirrors the reference's solve stack, SURVEY §3.1/§3.3):

    QuadraticModel (host, sparse)
      -> [optional presolve / Ruiz scaling, see models/]
      -> slack_form (equality-only constraints; MadNLP [x; s] layout)
      -> pad_to_device (padded dense DeviceQP pytree)
      -> solver.driver.solve_device / solve_logged (one jitted XLA program)
      -> IPMStats (unscaled, mapped back to the input model's variables)
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Union

import jax
import jax.numpy as jnp
import numpy as np

from .models.qp import DeviceQP, QuadraticModel, pad_to_device, slack_form
from .solver import driver
from .utils.options import IPMOptions, PrintLevel, load_options
from .utils.stats import IPMStats
from .utils.status import Status


def _ensure_x64():
    if not jax.config.jax_enable_x64:
        jax.config.update("jax_enable_x64", True)
    # fp32 matmuls may default to reduced-precision passes (TF32 tensor
    # cores on the GPU, ~10 mantissa bits) — fatal for the fp32 Cholesky
    # factor + refinement loop.  HIGHEST keeps true fp32 accuracy.
    if jax.config.jax_default_matmul_precision is None:
        jax.config.update("jax_default_matmul_precision", "highest")
    # Persistent compilation cache: repeated solves of same-shape problems
    # (the benchmark sweep pattern, scripts/benchmarks_cpu.jl:15-58) skip
    # recompilation across processes.
    if not jax.config.jax_compilation_cache_dir:
        from .utils.cache import configure_cache

        configure_cache(jax)


class MPCSolver:
    """Stateful convenience wrapper (reference ``MPCSolver(nlp; kwargs...)``,
    src/structure.jl:79-178): holds the transformed device problem and
    compiled solve so repeated solves reuse the XLA executable."""

    def __init__(
        self,
        model: QuadraticModel,
        dtype=None,
        pad_multiple: int = 128,
        sparse: Optional[bool] = None,
        mesh=None,
        **options,
    ):
        """``mesh`` (a jax.sharding.Mesh) distributes the single-instance
        solve: column-sharded problem data + strip-sharded normal-matrix
        factorization over the mesh (parallel/schur.py, parallel/dist_chol.py).
        NORMAL KKT (LPs) only; pad_multiple is raised so every padded
        dimension divides the mesh."""
        _ensure_x64()
        self.model = model
        self.opt = options.pop("options", None) or load_options(**options)
        self.dtype = jnp.dtype(dtype) if dtype is not None else jnp.float64
        self.mesh = mesh
        if mesh is not None:
            import math

            nsh = math.prod(mesh.shape.values())
            # every padded dim must divide the mesh (row strips + col shards)
            pad_multiple = max(pad_multiple, 128 * nsh)
        t0 = time.time()
        self.slack_model = slack_form(model)
        if sparse is None:
            # Auto: switch to the ELL/segment-sum representation when the
            # dense padded Jacobian would be big AND the problem is sparse
            # enough that the pair-list assembly wins (models/sparse.py).
            sm = self.slack_model
            dense_entries = sm.ncon * sm.nvar
            density = sm.A.nnz / max(1, dense_entries)
            sparse = (not sm.is_qp) and dense_entries > 64_000_000 and density < 0.02
        if sparse:
            from .models.sparse import pad_sparse_to_device
            from .utils.options import KKTSystem

            # Resolve the KKT formulation up front: sparse QPs go through
            # the K1 CONDENSED system (AUGMENTED would materialize the
            # dense block matrix); sparse LPs default to NORMAL.
            kkt = self.opt.resolved_kkt(self.slack_model.is_qp)
            if self.slack_model.is_qp and kkt != KKTSystem.CONDENSED:
                if self.opt.kkt_system is None:
                    kkt = KKTSystem.CONDENSED
                    self.opt = dataclasses.replace(
                        self.opt, kkt_system=KKTSystem.CONDENSED
                    )
                else:
                    raise ValueError(
                        f"sparse QPs require kkt_system=CONDENSED, got {kkt}"
                    )
            pat = {
                KKTSystem.NORMAL: "normal",
                KKTSystem.CONDENSED: "condensed",
            }.get(kkt)
            if pat is None:
                raise ValueError(
                    f"the sparse path supports NORMAL and CONDENSED KKT "
                    f"systems, got {kkt}"
                )
            self.prob = pad_sparse_to_device(
                self.slack_model, dtype=self.dtype, pad_multiple=pad_multiple,
                kkt=pat,
            )
        else:
            self.prob = pad_to_device(
                self.slack_model, dtype=self.dtype, pad_multiple=pad_multiple
            )
        if mesh is not None:
            if sparse:
                raise ValueError("mesh-distributed solves use the dense path")
            from .parallel.schur import shard_columns

            axis = list(mesh.shape.keys())[0]
            self.prob = shard_columns(self.prob, mesh, axis)
            self.cfg = driver.make_config(
                self.opt, is_qp=self.prob.is_qp, dtype=self.dtype,
                mesh=mesh, dist_axis=axis,
            )
        else:
            self.cfg = driver.make_config(
                self.opt, is_qp=self.prob.is_qp, dtype=self.dtype
            )
        self.init_time = time.time() - t0

    def solve(
        self, logged: bool = None, trace_dir: str = None, timed: bool = False
    ) -> IPMStats:
        """Run the MPC loop.  ``trace_dir`` captures an XLA profiler trace
        of the solve (utils/logging.profile_trace); ``logged`` forces the
        per-iteration table on/off (default: on at print_level<=INFO,
        routed through the Logger with its optional ``output_file`` sink —
        reference: src/utils.jl:131-137).  ``timed=True`` runs the
        phase-timed driver instead, filling ``IPMStats.linear_solver_time``
        (the reference's per-instance counter, scripts/benchmarks_cpu.jl:50)
        at the cost of per-phase host syncs."""
        from .utils.logging import Logger, profile_trace

        t0 = time.time()
        if logged is None:
            # The per-iteration table is produced whenever EITHER sink wants
            # it (quiet console + verbose file sink still logs — MadNLPLogger
            # semantics, reference src/utils.jl:131-137).
            effective = self.opt.print_level
            if self.opt.output_file:
                effective = min(effective, self.opt.file_print_level)
            logged = effective <= PrintLevel.INFO
        logger = Logger(
            print_level=self.opt.print_level,
            file_print_level=self.opt.file_print_level,
            output_file=self.opt.output_file,
        )
        # Host-side exceptions map to a status unless rethrow_error, like
        # the reference's try/catch ladder (src/solver.jl:374-405 guarded by
        # `solver.opt.rethrow_error && rethrow(e)`).  On-device NaNs are
        # handled separately inside the loop (ERROR_IN_STEP_COMPUTATION).
        lin_time = None
        try:
            with profile_trace(trace_dir):
                if timed:
                    prob_s, scale, state, timers = driver.solve_timed(
                        self.cfg,
                        self.prob,
                        max_wall_time=self.opt.max_wall_time,
                    )
                    lin_time = timers["linear_solver_time"]
                elif logged:
                    prob_s, scale, state = driver.solve_logged(
                        self.cfg,
                        self.prob,
                        print_fn=logger.info,
                        max_wall_time=self.opt.max_wall_time,
                    )
                elif self.opt.max_wall_time < 1e6:
                    # Finite wall-time budget: the chunked driver enforces it
                    # in-loop (reference src/solver.jl:216).
                    prob_s, scale, state = driver.solve_device_chunked(
                        self.cfg, self.prob, self.opt.max_wall_time
                    )
                else:
                    run = jax.jit(driver.solve_device, static_argnums=0)
                    prob_s, scale, state = run(self.cfg, self.prob)
                    state = jax.tree_util.tree_map(
                        lambda a: a.block_until_ready(), state
                    )
        except KeyboardInterrupt:
            if self.opt.rethrow_error:
                raise
            stats = self._error_stats(Status.USER_REQUESTED_STOP, time.time() - t0)
            logger.notice(f"EXIT: {stats.message()}")
            logger.close()
            return stats
        except Exception as e:  # noqa: BLE001 — status-mapping boundary
            if self.opt.rethrow_error:
                raise
            logger.error(f"solve failed: {type(e).__name__}: {e}")
            stats = self._error_stats(Status.INTERNAL_ERROR, time.time() - t0)
            logger.notice(f"EXIT: {stats.message()}")
            logger.close()
            return stats
        solver_time = time.time() - t0
        stats = self._build_stats(scale, state, solver_time, lin_time)
        logger.notice(
            f"EXIT: {stats.message()}  (iter={stats.iter}, "
            f"obj={stats.objective:.8e}, time={stats.total_time:.3f}s)"
        )
        logger.close()
        return stats

    def _error_stats(self, status: Status, solver_time: float) -> IPMStats:
        """Stats shell for a solve that died host-side (no iterate available)."""
        m0, n0 = self.model.ncon, self.model.nvar
        return IPMStats(
            status=status,
            objective=float("nan"),
            solution=np.full(n0, np.nan),
            constraints=np.full(m0, np.nan),
            multipliers=np.full(m0, np.nan),
            multipliers_L=np.full(n0, np.nan),
            multipliers_U=np.full(n0, np.nan),
            iter=0,
            primal_feas=float("inf"),
            dual_feas=float("inf"),
            complementarity=float("inf"),
            total_time=solver_time + self.init_time,
            init_time=self.init_time,
            solver_time=solver_time,
        )

    def _build_stats(self, scale, state, solver_time, lin_time=None) -> IPMStats:
        m0, n0 = self.model.ncon, self.model.nvar
        osc = float(scale.obj_scale)
        csc = np.asarray(scale.con_scale)[:m0]
        x = np.asarray(state.x)[:n0]
        y = np.asarray(state.y)[:m0] * csc / osc
        zl = np.asarray(state.zl)[:n0] / osc
        zu = np.asarray(state.zu)[:n0] / osc
        objective = float(state.obj_val) / osc
        sign = 1.0 if self.model.minimize else -1.0
        status = Status(int(state.status))
        return IPMStats(
            status=status,
            objective=sign * objective,
            solution=x,
            constraints=self.model.cons(x),
            multipliers=y,
            multipliers_L=zl,
            multipliers_U=zu,
            iter=int(state.k),
            primal_feas=float(state.inf_pr),
            dual_feas=float(state.inf_du),
            complementarity=float(state.inf_compl),
            total_time=solver_time + self.init_time,
            init_time=self.init_time,
            solver_time=solver_time,
            linear_solver_time=lin_time,
        )


def madipm(model: QuadraticModel, **options) -> IPMStats:
    """Solve an LP/QP with the Mehrotra predictor-corrector interior-point
    method (reference: src/solver.jl:420-428).

    For maximization models the objective is negated on entry and the
    reported objective flipped back (reference update_solution!,
    src/utils.jl:150-156).
    """
    if not model.minimize:
        import dataclasses as _dc

        neg = QuadraticModel(
            c=-model.c,
            A=model.A,
            lcon=model.lcon,
            ucon=model.ucon,
            lvar=model.lvar,
            uvar=model.uvar,
            Q=None if model.Q is None else -model.Q,
            c0=-model.c0,
            x0=model.x0,
            y0=model.y0,
            name=model.name,
            minimize=False,  # remembered so stats flips the sign back
        )
        solver = MPCSolver(neg, **options)
        return solver.solve()
    solver = MPCSolver(model, **options)
    return solver.solve()
