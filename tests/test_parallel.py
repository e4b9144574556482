"""Multi-device tests on the 8-virtual-device CPU mesh.

The reference has no distributed story to mirror (SURVEY §2.3); these tests
validate the new capabilities: batched sharded sweeps and the
column-partitioned Schur KKT solve, following the survey's recommendation of
fake-device meshes (SURVEY §4 end).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import madipm_tpu as mt
from madipm_tpu.parallel import (
    bucket_pad,
    madipm_batch,
    make_mesh,
    schur_normal_solve,
    solve_sharded,
)
from madipm_tpu.solver import driver
from madipm_tpu.utils.options import load_options
from tests.conftest import random_lp, scipy_linprog


def _models(k, n, m, seed0=100):
    out = []
    for i in range(k):
        c, A, b, lvar, uvar = random_lp(None, n, m, seed=seed0 + i)
        out.append(mt.from_dense(c=c, A=A, lcon=b, ucon=b, lvar=lvar, uvar=uvar))
    return out


def test_device_count():
    assert len(jax.devices()) == 8


class TestBatched:
    def test_vmapped_batch_matches_serial(self):
        models = _models(4, 20, 6)
        stats = madipm_batch(models, print_level=mt.PrintLevel.ERROR)
        assert len(stats) == 4
        for model, st in zip(models, stats):
            ref = mt.madipm(model, print_level=mt.PrintLevel.ERROR)
            assert st.success
            assert st.objective == pytest.approx(ref.objective, abs=1e-7)
            assert st.iter == ref.iter

    def test_sharded_batch(self):
        mesh = make_mesh(8, axis_names=("batch",))
        models = _models(8, 16, 5, seed0=200)
        stats = madipm_batch(models, mesh=mesh, print_level=mt.PrintLevel.ERROR)
        for model, st in zip(models, stats):
            assert st.success, st.message()
            c, A = model.c, model.A.toarray()
            ref = scipy_linprog(c, A, model.lcon, model.lvar, model.uvar)
            assert st.objective == pytest.approx(ref.fun, abs=1e-5)

    def test_mixed_statuses(self):
        # One infeasible instance must not poison the batch.
        models = _models(3, 16, 5, seed0=300)
        bad = mt.from_dense(
            c=np.ones(16),
            A=np.vstack([np.ones(16), np.ones(16)]),
            lcon=[1.0, 2.0],
            ucon=[1.0, 2.0],  # inconsistent equalities
            lvar=np.zeros(16),
            uvar=np.full(16, np.inf),
        )
        stats = madipm_batch(models + [bad], print_level=mt.PrintLevel.ERROR)
        assert all(s.success for s in stats[:3])
        assert not stats[3].success


class TestSchur:
    def test_column_sharded_solve(self):
        mesh = make_mesh(8, axis_names=("cols",))
        c, A, b, lvar, uvar = random_lp(None, 60, 20, seed=55)
        qp = mt.from_dense(c=c, A=A, lcon=b, ucon=b, lvar=lvar, uvar=uvar)
        solver = mt.MPCSolver(qp, print_level=mt.PrintLevel.ERROR, pad_multiple=128)
        _, scale, state = solve_sharded(solver.cfg, solver.prob, mesh)
        stats = solver._build_stats(scale, state, 0.0)
        assert stats.success
        ref = scipy_linprog(c, A, b, lvar, uvar)
        assert stats.objective == pytest.approx(ref.fun, abs=1e-5)

    def test_schur_kernel_matches_dense(self):
        """Explicit psum Schur solve == single-device normal solve."""
        mesh = make_mesh(8, axis_names=("cols",))
        rng = np.random.default_rng(0)
        m, n = 16, 128  # n divisible by 8
        A = jnp.asarray(rng.standard_normal((m, n)))
        dinv = jnp.asarray(rng.random(n) + 0.5)
        rx = jnp.asarray(rng.standard_normal(n))
        rp = jnp.asarray(rng.standard_normal(m))
        row_mask = jnp.ones(m, dtype=bool)
        del_c = 0.0

        dx, dy = schur_normal_solve(mesh, A, dinv, rx, rp, row_mask, del_c)

        S = (A * dinv[None, :]) @ A.T
        dy_ref = np.linalg.solve(np.asarray(S), np.asarray(A @ (dinv * rx) - rp))
        dx_ref = np.asarray(dinv * (rx - A.T @ jnp.asarray(dy_ref)))
        assert np.allclose(np.asarray(dy), dy_ref, atol=1e-8)
        assert np.allclose(np.asarray(dx), dx_ref, atol=1e-8)


class TestDistCholesky:
    """Distributed blocked Cholesky (parallel/dist_chol.py): the m x m
    factorization itself partitioned over the mesh (SURVEY §7 step 7 —
    capability the single-device reference lacks)."""

    def _mesh(self):
        return make_mesh(8, axis_names=("cols",))

    def test_factor_matches_numpy(self):
        from madipm_tpu.parallel.dist_chol import dist_cholesky

        mesh = self._mesh()
        rng = np.random.default_rng(3)
        m = 128  # 8 strips of 16
        G = rng.standard_normal((m, m))
        S = G @ G.T + m * np.eye(m)
        L, W = dist_cholesky(mesh, jnp.asarray(S))
        Lref = np.linalg.cholesky(S)
        assert np.allclose(np.asarray(L), Lref, atol=1e-8 * m)

    def test_solve_matches_numpy(self):
        from madipm_tpu.parallel.dist_chol import dist_cholesky, dist_chol_solve

        mesh = self._mesh()
        rng = np.random.default_rng(4)
        m = 128
        G = rng.standard_normal((m, m))
        S = G @ G.T + m * np.eye(m)
        b = rng.standard_normal(m)
        L, W = dist_cholesky(mesh, jnp.asarray(S))
        x = dist_chol_solve(mesh, L, W, jnp.asarray(b))
        assert np.allclose(np.asarray(x), np.linalg.solve(S, b), atol=1e-8)

    def test_schur_with_distributed_factor(self):
        """Column-sharded Schur assembly + distributed factor == dense."""
        from madipm_tpu.parallel.dist_chol import schur_normal_solve_dist

        mesh = self._mesh()
        rng = np.random.default_rng(5)
        m, n = 64, 128  # both divisible by 8
        A = rng.standard_normal((m, n))
        dinv = rng.random(n) + 0.5
        rx = rng.standard_normal(n)
        rp = rng.standard_normal(m)
        row_mask = np.ones(m, bool)
        del_c = -1e-8
        dx, dy = schur_normal_solve_dist(
            mesh, jnp.asarray(A), jnp.asarray(dinv), jnp.asarray(rx),
            jnp.asarray(rp), jnp.asarray(row_mask), del_c,
        )
        Sn = A @ np.diag(dinv) @ A.T - del_c * np.eye(m)
        dy_ref = np.linalg.solve(Sn, A @ (dinv * rx) - rp)
        dx_ref = dinv * (rx - A.T @ dy_ref)
        assert np.allclose(np.asarray(dy), dy_ref, atol=1e-7)
        assert np.allclose(np.asarray(dx), dx_ref, atol=1e-7)


class TestIntegratedDistFactor:
    """The distributed factorization INSIDE the solver (VERDICT.md item 3):
    cfg.kkt.dist_mesh routes every per-iteration NORMAL factorize/solve
    through parallel/dist_chol.dist_factor_normal — the m x m factor is
    strip-sharded, never replicated."""

    def _solve_pair(self, n, m, seed, **opts):
        mesh = make_mesh(8, axis_names=("cols",))
        c, A, b, lvar, uvar = random_lp(None, n, m, seed=seed)
        qp = mt.from_dense(c=c, A=A, lcon=b, ucon=b, lvar=lvar, uvar=uvar)
        solver = mt.MPCSolver(
            qp, print_level=mt.PrintLevel.ERROR, pad_multiple=128, **opts
        )
        # single-device reference
        import jax as _jax

        run = _jax.jit(driver.solve_device, static_argnums=0)
        _, scale1, st1 = run(solver.cfg, solver.prob)
        # distributed factor
        _, scale2, st2 = solve_sharded(
            solver.cfg, solver.prob, mesh, distribute_factor=True
        )
        return solver, scale1, st1, scale2, st2

    def test_full_solve_parity(self):
        solver, scale1, st1, scale2, st2 = self._solve_pair(96, 24, seed=77)
        assert int(st2.status) == int(st1.status)
        # identical iterate path: same factorization math, same iteration
        # count; objectives match to solver tolerance
        assert int(st2.k) == int(st1.k)
        s1 = solver._build_stats(scale1, st1, 0.0)
        s2 = solver._build_stats(scale2, st2, 0.0)
        assert s2.objective == pytest.approx(s1.objective, abs=1e-8)
        np.testing.assert_allclose(s2.solution, s1.solution, atol=1e-6)

    def test_fp32_factor_parity(self):
        # the mixed-precision route: fp32 strip factor + fp64 PCG recovery
        solver, scale1, st1, scale2, st2 = self._solve_pair(
            96, 24, seed=78,
            linear_solver=mt.LinearSolver.CHOLESKY_INV,
            factor_dtype="float32",
            refinement_steps=6,
        )
        assert int(st2.status) == int(st1.status)
        s1 = solver._build_stats(scale1, st1, 0.0)
        s2 = solver._build_stats(scale2, st2, 0.0)
        assert s2.objective == pytest.approx(s1.objective, abs=1e-7)

    def test_mesh_via_mpcsolver(self):
        # MPCSolver(mesh=...) end-to-end: pad raised to 128*8, solve ok.
        mesh = make_mesh(8, axis_names=("cols",))
        c, A, b, lvar, uvar = random_lp(None, 80, 20, seed=79)
        qp = mt.from_dense(c=c, A=A, lcon=b, ucon=b, lvar=lvar, uvar=uvar)
        solver = mt.MPCSolver(qp, mesh=mesh, print_level=mt.PrintLevel.ERROR)
        assert solver.cfg.kkt.dist_mesh is mesh
        assert solver.prob.m % (8 * 128) == 0
        stats = solver.solve(logged=False)
        assert stats.success
        ref = scipy_linprog(c, A, b, lvar, uvar)
        assert stats.objective == pytest.approx(ref.fun, abs=1e-5)


class TestDistCondensed:
    """Distributed K1 (CONDENSED): multi-chip QPs (round-3, VERDICT #6).
    The size-n SPD system is assembled from row-sharded A blocks and
    strip-factored (parallel/dist_chol.dist_factor_condensed); parity is
    pinned against the replicated K1 solve."""

    def _qp_model(self, seed, n=24, m=8):
        rng = np.random.default_rng(seed)
        A = rng.standard_normal((m, n))
        xstar = rng.random(n) + 0.5
        B = rng.standard_normal((n // 2, n)) / np.sqrt(n)
        Q = B.T @ B + 0.3 * np.eye(n)
        import scipy.sparse as sp

        from madipm_tpu.models.qp import QuadraticModel

        return QuadraticModel(
            c=rng.standard_normal(n), A=sp.csr_matrix(A),
            lcon=A @ xstar, ucon=A @ xstar,
            lvar=np.zeros(n), uvar=np.full(n, np.inf),
            Q=sp.csr_matrix(Q),
        )

    def test_dense_qp_parity(self):
        mesh = make_mesh(8, axis_names=("cols",))
        qp = self._qp_model(31)
        opts = dict(
            print_level=mt.PrintLevel.ERROR, kkt_system=mt.KKTSystem.CONDENSED
        )
        ref = mt.MPCSolver(qp, **opts).solve(logged=False)
        assert ref.success
        solver = mt.MPCSolver(qp, mesh=mesh, **opts)
        from madipm_tpu.utils.options import KKTSystem

        assert solver.cfg.kkt.kind == KKTSystem.CONDENSED
        assert solver.cfg.kkt.dist_mesh is mesh
        stats = solver.solve(logged=False)
        assert stats.success, stats.status
        assert stats.objective == pytest.approx(ref.objective, abs=1e-7)
        assert stats.iter == ref.iter  # identical iterate path

    def test_dense_qp_fp32_strip_factor(self):
        # mixed-precision route: fp32 strip factor + fp64 PCG recovery.
        mesh = make_mesh(8, axis_names=("cols",))
        qp = self._qp_model(32)
        opts = dict(
            print_level=mt.PrintLevel.ERROR,
            kkt_system=mt.KKTSystem.CONDENSED,
            linear_solver=mt.LinearSolver.CHOLESKY_INV,
            factor_dtype="float32",
            refinement_steps=8,
        )
        ref = mt.MPCSolver(qp, **opts).solve(logged=False)
        solver = mt.MPCSolver(qp, mesh=mesh, **opts)
        stats = solver.solve(logged=False)
        assert stats.success, stats.status
        assert ref.success
        assert stats.objective == pytest.approx(ref.objective, abs=1e-6)
