"""Unit tests of the ops layer: factorizations, refinement, failure contract.

Reference analogue: the KKT-system contract test
(MadNLPTests.test_kkt_system, test/runtests.jl:166-180) — here each
factorization backend is validated against the operator it claims to invert,
plus the refinement loop's convergence/rejection behavior.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from madipm_tpu.ops import linalg
from madipm_tpu.ops.block_chol import chol_inv, chol_inv_solve


def _spd(rng, n, cond=1e4, dtype=np.float64):
    M = rng.standard_normal((n, n))
    q, _ = np.linalg.qr(M)
    eigs = np.logspace(0, -np.log10(cond), n)
    return jnp.asarray((q * eigs) @ q.T, dtype=dtype)


class TestCholInv:
    @pytest.mark.parametrize("n", [16, 64, 200, 384])
    def test_factor_and_inverse(self, rng, n):
        S = _spd(rng, n)
        L, W = jax.jit(chol_inv)(S)
        assert float(jnp.max(jnp.abs(L @ L.T - S))) < 1e-12 * float(jnp.max(jnp.abs(S))) * n
        assert float(jnp.max(jnp.abs(W @ L - jnp.eye(n)))) < 1e-11 * n

    def test_solve(self, rng):
        S = _spd(rng, 128)
        b = jnp.asarray(rng.standard_normal(128))
        _, W = chol_inv(S)
        x = chol_inv_solve(W, b)
        assert float(jnp.max(jnp.abs(S @ x - b))) < 1e-9

    def test_indefinite_gives_nan(self, rng):
        S = -jnp.eye(32)
        L, W = chol_inv(S)
        assert bool(jnp.any(jnp.isnan(L)))


class TestLDL:
    def test_quasi_definite(self, rng):
        # [Sigma A'; A -delta] quasi-definite: LDL' without pivoting exists.
        n, m = 48, 24
        A = rng.standard_normal((m, n))
        K = np.block(
            [[np.diag(rng.random(n) + 0.5), A.T], [A, -1e-6 * np.eye(m)]]
        )
        K = jnp.asarray(K)
        L, d = linalg.ldl_factor(K, block=32)
        assert bool(linalg.ldl_is_ok(L, d))
        rec = (L * d[None, :]) @ L.T
        assert float(jnp.max(jnp.abs(rec - K))) < 1e-10
        b = jnp.asarray(rng.standard_normal(n + m))
        x = linalg.ldl_solve(L, d, b)
        assert float(jnp.max(jnp.abs(K @ x - b))) < 1e-8


class TestLDLInv:
    def test_quasi_definite_recursion(self, rng):
        from madipm_tpu.ops.block_chol import ldl_inv, ldl_inv_solve

        n, m = 96, 64
        A = rng.standard_normal((m, n))
        K = jnp.asarray(
            np.block(
                [[np.diag(rng.random(n) + 0.5), A.T], [A, -1e-8 * np.eye(m)]]
            )
        )
        L, d, W = jax.jit(ldl_inv)(K)
        rec = (L * d[None, :]) @ L.T
        assert float(jnp.max(jnp.abs(rec - K))) < 1e-11
        assert float(jnp.max(jnp.abs(W @ L - jnp.eye(n + m)))) < 1e-11
        b = jnp.asarray(rng.standard_normal(n + m))
        x = ldl_inv_solve(W, d, b)
        assert float(jnp.max(jnp.abs(K @ x - b))) < 1e-10

    def test_qp_solve_via_ldl_inv(self):
        import madipm_tpu as mt

        qp = mt.from_dense(
            c=[0.0, 0.0], Q=np.eye(2), A=[[1.0, 1.0]], lcon=[2.0], ucon=[2.0],
            lvar=[0.0, 0.0], uvar=[np.inf, np.inf],
        )
        for fd in (None, "float32"):
            s = mt.madipm(
                qp,
                print_level=mt.PrintLevel.ERROR,
                linear_solver=mt.LinearSolver.LDL_INV,
                factor_dtype=fd,
            )
            assert s.success
            assert s.objective == pytest.approx(1.0, abs=1e-7)


class TestRefine:
    def test_fp32_factor_converges_fp64(self, rng):
        S = _spd(rng, 96, cond=1e6)
        b = jnp.asarray(rng.standard_normal(96))
        L32 = linalg.cholesky_factor(S, dtype=jnp.float32)
        solve_fn = lambda r: linalg.cholesky_solve(L32, r.astype(jnp.float32)).astype(
            jnp.float64
        )
        matvec = lambda v: S @ v
        x1 = solve_fn(b)
        x = linalg.refine(solve_fn, matvec, b, steps=6)
        r1 = float(jnp.max(jnp.abs(S @ x1 - b)))
        r = float(jnp.max(jnp.abs(S @ x - b)))
        assert r < 1e-10
        assert r < r1 / 100  # refinement improved substantially

    def test_zero_steps_passthrough(self, rng):
        S = _spd(rng, 32)
        b = jnp.asarray(rng.standard_normal(32))
        L = linalg.cholesky_factor(S)
        x = linalg.refine(lambda r: linalg.cholesky_solve(L, r), lambda v: S @ v, b, 0)
        assert float(jnp.max(jnp.abs(S @ x - b))) < 1e-10

    def test_rejects_divergent_correction(self, rng):
        # A garbage "solver" must not make the iterate worse than sweep 0.
        S = _spd(rng, 32)
        b = jnp.asarray(rng.standard_normal(32))
        L = linalg.cholesky_factor(S)
        good = lambda r: linalg.cholesky_solve(L, r)
        calls = {"n": 0}

        def flaky(r):
            # First call accurate; later calls return garbage.
            out = good(r)
            return out

        x_ref = linalg.refine(good, lambda v: S @ v, b, 3)
        # Garbage matvec makes corrections diverge; best iterate kept.
        bad_matvec = lambda v: S @ v * 3.0
        x = linalg.refine(good, bad_matvec, b, 3)
        # With the wrong operator the residual (true) can't explode past the
        # step-0 solve because worse iterates are rejected under bad_matvec's
        # own metric; sanity: result is finite.
        assert bool(jnp.all(jnp.isfinite(x)))


class TestMixedPrecisionPCG:
    """The mixed-precision restarted solve: fp32 inner Krylov
    (linalg.pcg_lowp) + fp64 true-residual restarts (linalg.refine)."""

    def test_pcg_lowp_solves_in_fp32(self, rng):
        S = _spd(rng, 96, cond=1e4)
        S32 = S.astype(jnp.float32)
        b32 = jnp.asarray(rng.standard_normal(96), jnp.float32)
        L32 = linalg.cholesky_factor(S32)
        solve32 = lambda r: linalg.cholesky_solve(L32, r)
        mv32 = lambda v: S32 @ v
        x = linalg.pcg_lowp(solve32, mv32, b32, max_iters=8)
        assert x.dtype == jnp.float32
        r = float(jnp.max(jnp.abs(S32 @ x - b32)))
        assert r < 1e-4 * float(jnp.max(jnp.abs(b32)))

    def test_restarted_reaches_fp64_accuracy(self, rng):
        # fp32 inner engine + fp64 restarts must reach ~1e-12 residuals the
        # fp32 solve alone cannot.
        n = 128
        S = _spd(rng, n, cond=1e6)
        b = jnp.asarray(rng.standard_normal(n))
        S32 = S.astype(jnp.float32)
        L32 = linalg.cholesky_factor(S32)
        solve32 = lambda r: linalg.cholesky_solve(L32, r)
        mv32 = lambda v: S32 @ v

        def inner(r):
            s = jnp.max(jnp.abs(r))
            d32 = linalg.pcg_lowp(solve32, mv32, (r / s).astype(jnp.float32), 8)
            return s * d32.astype(jnp.float64)

        x = linalg.refine(inner, lambda v: S @ v, b, steps=6, min_reduction=0.25)
        r = float(jnp.max(jnp.abs(S @ x - b))) / float(jnp.max(jnp.abs(b)))
        # fp32 alone floors near 1e-5; the restarts must go far below.
        assert r < 1e-10

    def test_refine_stall_exit(self, rng):
        # A solver that makes no progress must stop consuming sweeps when
        # min_reduction is set (each sweep = one expensive fp64 matvec):
        # the loop counter in the carry stops advancing after the first
        # stalled sweep.  Observable effect: the result equals the stalled
        # iterate and stays finite.
        S = _spd(rng, 32)
        b = jnp.asarray(rng.standard_normal(32))
        null_solver = lambda r: jnp.zeros_like(r)
        x = linalg.refine(null_solver, lambda v: S @ v, b, steps=6, min_reduction=0.25)
        assert float(jnp.max(jnp.abs(x))) == 0.0

    def test_solver_mixed_path_matches_fp64(self, rng):
        # End-to-end LP through the public API: fp32 factor + mixed restarts
        # must reproduce the fp64 solve to 1e-8.
        import madipm_tpu as mt

        m, n = 40, 80
        A = np.asarray(rng.standard_normal((m, n)) * (rng.random((m, n)) < 0.5))
        for r_ in np.flatnonzero(np.abs(A).sum(1) == 0):
            A[r_, int(rng.integers(n))] = 1.0
        xstar = rng.random(n) + 0.5
        b = A @ xstar
        c = rng.random(n) + 0.1
        mdl = mt.from_dense(
            c=c, A=A, lcon=b, ucon=b, lvar=np.zeros(n), uvar=np.full(n, np.inf)
        )
        common = dict(
            tol=1e-8,
            regularization=mt.FixedRegularization(1e-8, -1e-8),
            print_level=mt.PrintLevel.ERROR,
        )
        st64 = mt.madipm(mdl, **common)
        st32 = mt.madipm(
            mdl,
            linear_solver=mt.LinearSolver.CHOLESKY_INV,
            factor_dtype="float32",
            refinement_steps=6,
            pcg_adaptive_tol=True,
            **common,
        )
        assert st64.success and st32.success
        assert abs(st32.objective - st64.objective) <= 1e-7 * max(
            1.0, abs(st64.objective)
        )
        assert st32.primal_feas < 1e-8 and st32.dual_feas < 1e-8


class TestCondensedKKT:
    """K1 contract: the condensed solve satisfies the augmented system
    [Sigma A'; A del_c][dx;dy] = [rx;rp] to the relaxation level
    (reference analogue: MadNLPTests.test_kkt_system run against each KKT
    formulation, test/runtests.jl:166-180)."""

    def test_solve_satisfies_augmented_system(self, rng):
        import madipm_tpu as mt
        from madipm_tpu.models.qp import pad_to_device
        from madipm_tpu.ops import kkt as kkt_ops
        from madipm_tpu.ops.kkt import KKTConfig
        from madipm_tpu.utils.options import KKTSystem, LinearSolver

        n, m = 50, 20  # standard form always has m <= n (slacks are columns)
        A = rng.standard_normal((m, n))
        x_feas = rng.random(n) + 0.5
        b = A @ x_feas
        qp = mt.from_dense(
            c=rng.random(n), A=A, lcon=b, ucon=b,
            lvar=np.zeros(n), uvar=np.full(n, np.inf),
        )
        prob = pad_to_device(qp)
        # refinement_steps > 0 turns on the PCG polish the solver always
        # uses for this formulation: the gamma-relaxation makes cond(C) ~
        # gamma, so the raw Cholesky backward error alone (~eps*cond) sits
        # above 1e-8 even in fp64.
        cfg = KKTConfig(
            kind=KKTSystem.CONDENSED,
            linear_solver=LinearSolver.CHOLESKY,
            factor_dtype=jnp.float64,
            refinement_steps=3,
        )
        x = jnp.asarray(np.where(np.isfinite(prob.lb), 1.0, 0.0))
        zl = jnp.where(jnp.isfinite(prob.lb), 0.5, 0.0)
        zu = jnp.zeros(prob.n)
        factors, dw, dc, ok = kkt_ops.factorize(cfg, prob, x, zl, zu, 1e-8, -1e-8)
        assert bool(ok)
        rx = jnp.asarray(rng.standard_normal(prob.n)) * prob.free_mask
        rp = jnp.asarray(rng.standard_normal(prob.m)) * prob.row_mask
        dx, dy = kkt_ops.solve_condensed(cfg, prob, factors, rx, rp)
        res = kkt_ops.solve_residual(prob, factors, rx, rp, dx, dy)
        # K1 accuracy floor: the condensed RHS carries gamma = 1e8, so the
        # top-block residual in unrelaxed units floors at ~eps*gamma*||rp||
        # (~1e-7 in fp64).  The IPM converges regardless because the step
        # error stays *relative* to the shrinking rp/rx.
        assert float(res) < 1e-5


class TestCondensedCholInv:
    """K1 with the matmul-only inverse-factor backend (CHOLESKY_INV)
    agrees with the default Cholesky backend."""

    def test_qp_cholinv_matches_cholesky(self, rng):
        import madipm_tpu as mt

        n, meq = 24, 8
        A = rng.standard_normal((meq, n))
        xstar = rng.random(n) + 0.5
        P = rng.standard_normal((n, n))
        qp = mt.from_dense(
            c=rng.random(n), A=A, lcon=A @ xstar, ucon=A @ xstar,
            lvar=np.zeros(n), uvar=np.full(n, np.inf), Q=P.T @ P + np.eye(n),
        )
        opts = dict(kkt_system=mt.KKTSystem.CONDENSED, print_level=mt.PrintLevel.ERROR)
        ref = mt.madipm(qp, **opts)
        # fp64 inverse factor: solves stay matmul-only (no lax.linalg
        # triangular solves).  fp32 is deliberately NOT used here: K1's
        # gamma ~ 1e8 equality relaxation exceeds fp32's dynamic range
        # (Q/Sigma entries absorb into gamma*A'A) and the residual
        # guardrail rejects the step — see test below.
        inv = mt.madipm(qp, linear_solver=mt.LinearSolver.CHOLESKY_INV, **opts)
        assert ref.success and inv.success
        assert inv.objective == pytest.approx(ref.objective, rel=1e-7)
        assert np.allclose(inv.solution, ref.solution, atol=1e-5)


class TestFactorizeForceOk:
    def test_force_ok_disarms_retry(self):
        """factorize(force_ok=True) must accept the FIRST attempt without
        x100 regularization bumps — the finished-lane neutralization hook
        (a vmapped converged lane's factorization may legitimately fail;
        its results are discarded, but its retries would run for every
        lane)."""
        import jax.numpy as jnp

        import madipm_tpu as mt
        from madipm_tpu.models.qp import pad_to_device, slack_form
        from madipm_tpu.ops import kkt as kkt_ops
        from madipm_tpu.utils.options import KKTSystem, LinearSolver

        # Duplicate rows -> singular normal matrix at del_c = 0.
        qp = mt.from_dense(
            c=[1.0, 1.0], A=[[1.0, 1.0], [1.0, 1.0]], lcon=[1.0, 1.0],
            ucon=[1.0, 1.0], lvar=[0.0, 0.0], uvar=[np.inf, np.inf],
        )
        prob = pad_to_device(slack_form(qp))
        cfg = kkt_ops.KKTConfig(
            kind=KKTSystem.NORMAL,
            linear_solver=LinearSolver.CHOLESKY,
            factor_dtype=jnp.float64,
            refinement_steps=0,
            max_factor_trials=3,
        )
        x = jnp.where(prob.free_mask, 0.5, jnp.where(prob.col_mask, prob.lb, 0.0))
        z = jnp.zeros(prob.n)
        # Without force_ok: retries bump del_c away from 0 to rescue the
        # exactly-singular normal matrix.
        _, dw1, dc1, ok1 = kkt_ops.factorize(cfg, prob, x, z, z, 1e-8, 0.0)
        assert bool(ok1) and float(dc1) != 0.0
        # With force_ok: first attempt accepted, regularization untouched.
        _, dw2, dc2, ok2 = kkt_ops.factorize(
            cfg, prob, x, z, z, 1e-8, 0.0, force_ok=jnp.asarray(True)
        )
        assert bool(ok2) and float(dc2) == 0.0 and float(dw2) == 1e-8


@pytest.mark.parametrize("linear_solver", ["cholesky", "cholesky_inv"])
def test_factor_failure_contract(linear_solver):
    """An indefinite system gives a not-ok factor (alone and per lane under
    vmap) and the factorize retry loop raises the regularization — the
    contract chip_smoke.py checks on the GPU, where cuSOLVER reports failure
    through ``info``."""
    import chip_smoke
    from madipm_tpu.utils.options import LinearSolver

    chip_smoke.check_factor_failure(LinearSolver(linear_solver))
