"""Differential/oracle tests of the MPC solver.

Replicates the reference's test strategy (test/runtests.jl): solve the same
problems with a trusted oracle (scipy HiGHS, playing MadNLP's role,
test/runtests.jl:10-27) and assert matching status/objective/solution; sweep
the strategy objects (step rules, regularizations, KKT systems,
test/runtests.jl:85-140); exercise the simple LP end-to-end
(test/runtests.jl:144-198).
"""

import numpy as np
import pytest

import madipm_tpu as mt
from tests.conftest import random_lp, scipy_linprog


def _solve(qp, **opts):
    opts.setdefault("print_level", mt.PrintLevel.ERROR)
    return mt.madipm(qp, **opts)


def simple_lp():
    """2-var LP from the reference tests (test/runtests.jl:29-60)."""
    return mt.from_dense(
        c=[1.0, 1.0],
        A=[[1.0, 1.0]],
        lcon=[1.0],
        ucon=[1.0],
        lvar=[0.0, 0.0],
        uvar=[np.inf, np.inf],
        x0=[1.0, 1.0],
        name="simpleLP",
    )


def _compare_with_oracle(c, A, b, lvar, uvar, atol=1e-5, **opts):
    qp = mt.from_dense(c=c, A=A, lcon=b, ucon=b, lvar=lvar, uvar=uvar)
    stats = _solve(qp, **opts)
    ref = scipy_linprog(c, A, b, lvar, uvar)
    assert ref.status == 0, "oracle failed"
    assert stats.success, stats.message()
    assert stats.objective == pytest.approx(ref.fun, abs=atol)
    # Solution may be non-unique; check feasibility + objective instead of x.
    assert np.allclose(A @ stats.solution, b, atol=1e-6)
    assert np.all(stats.solution >= lvar - 1e-6)
    assert np.all(stats.solution <= uvar + 1e-6)
    return stats


class TestSimpleLP:
    def test_solve(self):
        stats = _solve(simple_lp())
        assert stats.success
        assert stats.objective == pytest.approx(1.0, abs=1e-8)
        assert np.allclose(stats.solution, [0.5, 0.5], atol=1e-6)
        assert stats.multipliers[0] == pytest.approx(-1.0, abs=1e-6)

    def test_no_regularization(self):
        stats = _solve(simple_lp(), regularization=mt.NoRegularization())
        assert stats.success
        assert stats.objective == pytest.approx(1.0, abs=1e-8)

    def test_kkt_residual_of_solution(self):
        """Returned triple (x, y, zl) satisfies stationarity of the input
        problem — validates multiplier unscaling."""
        qp = simple_lp()
        stats = _solve(qp)
        r_d = qp.c + qp.A.T @ stats.multipliers - stats.multipliers_L + stats.multipliers_U
        assert np.max(np.abs(r_d)) < 1e-6


class TestRandomLPs:
    @pytest.mark.parametrize("n,m", [(10, 3), (30, 10), (80, 25)])
    def test_oracle_match(self, rng, n, m):
        c, A, b, lvar, uvar = random_lp(rng, n, m, seed=n * 100 + m)
        _compare_with_oracle(c, A, b, lvar, uvar)

    def test_gondzio_corrections(self, rng):
        c, A, b, lvar, uvar = random_lp(rng, 40, 15, seed=7)
        s0 = _compare_with_oracle(c, A, b, lvar, uvar, max_ncorr=0)
        s5 = _compare_with_oracle(c, A, b, lvar, uvar, max_ncorr=5)
        assert s5.iter <= s0.iter + 2  # corrections shouldn't hurt much

    def test_free_variables(self, rng):
        # x2 free: min x1 + x2 s.t. x1 - x2 = 1, x1 + x2 = 3
        qp = mt.from_dense(
            c=[1.0, 1.0],
            A=[[1.0, -1.0], [1.0, 1.0]],
            lcon=[1.0, 3.0],
            ucon=[1.0, 3.0],
            lvar=[0.0, -np.inf],
            uvar=[np.inf, np.inf],
        )
        stats = _solve(qp)
        assert stats.success
        assert np.allclose(stats.solution, [2.0, 1.0], atol=1e-6)

    def test_fixed_variables(self):
        # x1 fixed at 2: min x1 + x2 s.t. x1 + x2 = 5
        qp = mt.from_dense(
            c=[1.0, 1.0],
            A=[[1.0, 1.0]],
            lcon=[5.0],
            ucon=[5.0],
            lvar=[2.0, 0.0],
            uvar=[2.0, np.inf],
        )
        stats = _solve(qp)
        assert stats.success
        assert stats.solution[0] == pytest.approx(2.0, abs=1e-9)
        assert stats.solution[1] == pytest.approx(3.0, abs=1e-6)

    def test_inequality_constraints(self, rng):
        # General two-sided rows exercised through slack_form.
        n, m = 20, 8
        A = rng.standard_normal((m, n))
        x_int = rng.random(n) + 0.5
        mid = A @ x_int
        lcon = mid - rng.random(m)
        ucon = mid + rng.random(m)
        c = rng.random(n) + 0.1
        qp = mt.from_dense(
            c=c, A=A, lcon=lcon, ucon=ucon, lvar=np.zeros(n), uvar=np.full(n, np.inf)
        )
        stats = _solve(qp)
        assert stats.success
        from scipy.optimize import linprog

        res = linprog(
            c,
            A_ub=np.vstack([A, -A]),
            b_ub=np.concatenate([ucon, -lcon]),
            bounds=[(0, None)] * n,
            method="highs",
        )
        assert stats.objective == pytest.approx(res.fun, abs=1e-5)

    def test_upper_bounded_lp(self, rng):
        c, A, b, lvar, uvar = random_lp(rng, 25, 10, upper_frac=1.0, seed=3)
        _compare_with_oracle(c, A, b, lvar, uvar)

    def test_maximize(self):
        qp = mt.from_dense(
            c=[-1.0, -2.0],
            A=[[1.0, 1.0]],
            lcon=[-np.inf],
            ucon=[4.0],
            lvar=[0.0, 0.0],
            uvar=[np.inf, np.inf],
            minimize=False,
        )
        # max -x1 - 2x2 s.t. x1+x2 <= 4, x >= 0 -> optimum at origin, obj 0
        stats = _solve(qp)
        assert stats.success
        assert stats.objective == pytest.approx(0.0, abs=1e-6)


class TestStepRules:
    """Reference: test/runtests.jl:85-97."""

    @pytest.mark.parametrize(
        "rule",
        [
            mt.AdaptiveStep(0.99),
            mt.ConservativeStep(0.99),
            mt.MehrotraAdaptiveStep(0.99),
        ],
        ids=["adaptive", "conservative", "mehrotra_adaptive"],
    )
    def test_rule(self, rng, rule):
        c, A, b, lvar, uvar = random_lp(rng, 30, 10, seed=11)
        qp = mt.from_dense(c=c, A=A, lcon=b, ucon=b, lvar=lvar, uvar=uvar)
        stats = _solve(qp, step_rule=rule)
        assert stats.success
        ref = scipy_linprog(c, A, b, lvar, uvar)
        assert stats.objective == pytest.approx(ref.fun, abs=1e-5)


class TestRegularization:
    """Reference: test/runtests.jl:122-140."""

    @pytest.mark.parametrize(
        "reg",
        [
            mt.FixedRegularization(1e-8, -1e-9),
            mt.AdaptiveRegularization(1e-8, -1e-9, 1e-9),
            mt.NoRegularization(),
        ],
        ids=["fixed", "adaptive", "none"],
    )
    def test_reg(self, rng, reg):
        c, A, b, lvar, uvar = random_lp(rng, 30, 10, seed=13)
        qp = mt.from_dense(c=c, A=A, lcon=b, ucon=b, lvar=lvar, uvar=uvar)
        ref_stats = _solve(qp, regularization=mt.NoRegularization())
        stats = _solve(qp, regularization=reg)
        assert stats.success
        assert stats.objective == pytest.approx(ref_stats.objective, abs=1e-6)


class TestKKTSystems:
    """Augmented (K2) agrees with the condensed NORMAL path on LPs
    (reference analogue: K2.5 vs default, test/runtests.jl:107-120)."""

    def test_augmented_matches_normal(self, rng):
        c, A, b, lvar, uvar = random_lp(rng, 30, 10, seed=17)
        qp = mt.from_dense(c=c, A=A, lcon=b, ucon=b, lvar=lvar, uvar=uvar)
        s_norm = _solve(qp, kkt_system=mt.KKTSystem.NORMAL)
        s_aug = _solve(qp, kkt_system=mt.KKTSystem.AUGMENTED)
        assert s_norm.success and s_aug.success
        assert s_aug.objective == pytest.approx(s_norm.objective, abs=1e-7)
        assert s_aug.iter == s_norm.iter  # same math, different factorization

    def test_condensed_matches_normal_lp(self, rng):
        """K1 condensed (primal-space SPD system) reaches the NORMAL-path
        solution on an LP (reference analogue: SparseCondensedKKTSystem via
        kkt_system, exercised in test/test_gpu.jl:9-11)."""
        c, A, b, lvar, uvar = random_lp(rng, 30, 10, seed=23)
        qp = mt.from_dense(c=c, A=A, lcon=b, ucon=b, lvar=lvar, uvar=uvar)
        s_norm = _solve(qp, kkt_system=mt.KKTSystem.NORMAL)
        s_k1 = _solve(qp, kkt_system=mt.KKTSystem.CONDENSED)
        assert s_norm.success and s_k1.success
        # The gamma-relaxation perturbs the equalities at the 1e-8 level, so
        # agreement is a touch looser than the exact-formulation pairs.
        assert s_k1.objective == pytest.approx(s_norm.objective, abs=1e-5)

    def test_condensed_qp(self, rng):
        """K1 supports QPs (unlike NORMAL): differential check vs K2."""
        n, meq = 24, 8
        A = rng.standard_normal((meq, n))
        xstar = rng.random(n) + 0.5
        b = A @ xstar
        P = rng.standard_normal((n, n))
        Q = P.T @ P + np.eye(n)
        c = rng.random(n)
        qp = mt.from_dense(c=c, A=A, lcon=b, ucon=b, lvar=np.zeros(n),
                           uvar=np.full(n, np.inf), Q=Q)
        ref = _solve(qp)  # auto -> AUGMENTED for QP
        s_k1 = _solve(qp, kkt_system=mt.KKTSystem.CONDENSED)
        assert ref.success and s_k1.success
        assert s_k1.objective == pytest.approx(ref.objective, rel=1e-5)
        assert np.allclose(s_k1.solution, ref.solution, atol=1e-4)

    def test_normal_rejects_qp(self, rng):
        n = 5
        Q = np.eye(n)
        qp = mt.from_dense(
            c=np.ones(n), A=np.ones((1, n)), lcon=[1.0], ucon=[1.0],
            lvar=np.zeros(n), uvar=np.full(n, np.inf), Q=Q,
        )
        with pytest.raises(ValueError, match="linear programs"):
            mt.MPCSolver(qp, kkt_system=mt.KKTSystem.NORMAL)


class TestQP:
    def test_simple_qp(self):
        # min 1/2 (x1^2 + x2^2) s.t. x1 + x2 = 2 -> x = (1, 1), obj = 1
        qp = mt.from_dense(
            c=[0.0, 0.0], Q=np.eye(2), A=[[1.0, 1.0]], lcon=[2.0], ucon=[2.0],
            lvar=[-np.inf, -np.inf], uvar=[np.inf, np.inf],
        )
        stats = _solve(qp)
        assert stats.success
        assert np.allclose(stats.solution, [1.0, 1.0], atol=1e-6)
        assert stats.objective == pytest.approx(1.0, abs=1e-7)

    def test_bounded_qp(self, rng):
        n, m = 12, 4
        M = rng.standard_normal((n, n))
        Q = M @ M.T + np.eye(n)
        A = rng.standard_normal((m, n))
        xstar = rng.random(n)
        b = A @ xstar
        c = rng.standard_normal(n)
        qp = mt.from_dense(
            c=c, Q=Q, A=A, lcon=b, ucon=b, lvar=np.zeros(n), uvar=np.full(n, np.inf)
        )
        stats = _solve(qp)
        assert stats.success
        # Oracle: scipy solves the KKT conditions via active-set on the dual? Use
        # cvx-style check: projected-gradient optimality via KKT residual.
        x, y, zl = stats.solution, stats.multipliers, stats.multipliers_L
        r_d = c + Q @ x + A.T @ y - zl
        assert np.max(np.abs(r_d)) < 1e-6
        assert np.allclose(A @ x, b, atol=1e-6)
        assert np.all(x >= -1e-8)
        assert np.max(np.abs(x * zl)) < 1e-6  # complementarity


class TestInfeasibleUnbounded:
    def test_unbounded(self):
        # min -x1, x1 free-ish upward: x1 - x2 = 0, x >= 0 unbounded
        qp = mt.from_dense(
            c=[-1.0, 0.0], A=[[1.0, -1.0]], lcon=[0.0], ucon=[0.0],
            lvar=[0.0, 0.0], uvar=[np.inf, np.inf],
        )
        stats = _solve(qp)
        assert stats.status in (
            mt.Status.DIVERGING_ITERATES,
            mt.Status.INFEASIBLE_PROBLEM_DETECTED,
            mt.Status.MAXIMUM_ITERATIONS_EXCEEDED,
        )
        assert not stats.success

    def test_infeasible(self):
        # x1 + x2 = -1 with x >= 0 is infeasible
        qp = mt.from_dense(
            c=[1.0, 1.0], A=[[1.0, 1.0]], lcon=[-1.0], ucon=[-1.0],
            lvar=[0.0, 0.0], uvar=[np.inf, np.inf],
        )
        stats = _solve(qp)
        assert not stats.success

    def test_ls_certificate_kernel(self):
        """The least-squares certificate (the stall classifier's gate) must
        accept a true LS limit point and reject a noise-stalled point on a
        feasible instance (driver.update_termination; the misclassification
        it prevents was observed on a rhs-perturbed bench instance)."""
        import jax.numpy as jnp

        from madipm_tpu.models.qp import pad_to_device
        from madipm_tpu.solver import kernels as K

        # Conflicting equalities x0 = 1 and x0 = 3: LS optimum x0 = 2.
        qp = mt.from_dense(
            c=[1.0, 1.0], A=[[1.0, 0.0], [1.0, 0.0]],
            lcon=[1.0, 3.0], ucon=[1.0, 3.0],
            lvar=[0.0, 0.0], uvar=[np.inf, np.inf],
        )
        from madipm_tpu.models.qp import slack_form

        prob = pad_to_device(slack_form(qp))
        x_ls = jnp.zeros(prob.n).at[0].set(2.0).at[1].set(0.5)
        assert bool(K.ls_infeasibility_certificate(prob, x_ls))
        # A point whose residual is NOT LS-stationary (feasible problem
        # would have r -> 0; here x0=1.4 has descent available).
        x_noise = jnp.zeros(prob.n).at[0].set(1.4).at[1].set(0.5)
        assert not bool(K.ls_infeasibility_certificate(prob, x_noise))

    def test_infeasible_by_stall(self):
        # Conflicting equalities (x0 = 1 and x0 = 3): nothing diverges —
        # the MPC converges to the least-squares infeasible limit point
        # (inf_du, compl -> 0, inf_pr stuck at 1).  The stall detector
        # (driver.update_termination) must classify this as INFEASIBLE
        # within ~100 stalled iterations instead of grinding to max_iter.
        qp = mt.from_dense(
            c=[1.0, 1.0], A=[[1.0, 0.0], [1.0, 0.0]],
            lcon=[1.0, 3.0], ucon=[1.0, 3.0],
            lvar=[0.0, 0.0], uvar=[np.inf, np.inf],
        )
        stats = _solve(qp, max_iter=500)
        assert stats.status == mt.Status.INFEASIBLE_PROBLEM_DETECTED
        assert stats.iter < 300


class TestWallTimeAndTimed:
    def test_chunked_walltime_exceeded(self, rng):
        # Zero budget + chunk=1: the guard must fire after the first chunk
        # (reference enforces max_wall_time in-loop, src/solver.jl:216).
        from madipm_tpu.solver import driver as drv

        c, A, b, lvar, uvar = random_lp(None, 60, 20, seed=3)
        qp = mt.from_dense(c=c, A=A, lcon=b, ucon=b, lvar=lvar, uvar=uvar)
        solver = mt.MPCSolver(qp, print_level=mt.PrintLevel.ERROR)
        _, _, state = drv.solve_device_chunked(
            solver.cfg, solver.prob, max_wall_time=0.0, chunk=1
        )
        assert int(state.status) == int(mt.Status.MAXIMUM_WALLTIME_EXCEEDED)

    def test_chunked_normal_completion(self, rng):
        c, A, b, lvar, uvar = random_lp(None, 60, 20, seed=4)
        qp = mt.from_dense(c=c, A=A, lcon=b, ucon=b, lvar=lvar, uvar=uvar)
        solver = mt.MPCSolver(
            qp, print_level=mt.PrintLevel.ERROR, max_wall_time=300.0
        )
        stats = solver.solve(logged=False)  # routes through the chunked driver
        assert stats.success
        ref = scipy_linprog(c, A, b, lvar, uvar)
        assert abs(stats.objective - ref.fun) < 1e-6 * max(1, abs(ref.fun))

    def test_timed_driver_records_linear_solver_time(self, rng):
        c, A, b, lvar, uvar = random_lp(None, 60, 20, seed=5)
        qp = mt.from_dense(c=c, A=A, lcon=b, ucon=b, lvar=lvar, uvar=uvar)
        solver = mt.MPCSolver(qp, print_level=mt.PrintLevel.ERROR)
        stats = solver.solve(timed=True)
        assert stats.success
        assert stats.linear_solver_time is not None
        assert 0 < stats.linear_solver_time <= stats.solver_time
        # same solution as the fused path
        fused = mt.madipm(qp, print_level=mt.PrintLevel.ERROR)
        assert abs(stats.objective - fused.objective) < 1e-8 * max(
            1, abs(fused.objective)
        )

    def test_rethrow_error(self, rng, monkeypatch):
        c, A, b, lvar, uvar = random_lp(None, 30, 10, seed=6)
        qp = mt.from_dense(c=c, A=A, lcon=b, ucon=b, lvar=lvar, uvar=uvar)
        from madipm_tpu.solver import driver as drv

        def boom(*a, **k):
            raise RuntimeError("synthetic failure")

        # default: mapped to INTERNAL_ERROR stats (reference try/catch
        # ladder, src/solver.jl:374-405)
        solver = mt.MPCSolver(qp, print_level=mt.PrintLevel.ERROR)
        monkeypatch.setattr(drv, "solve_logged", boom)
        stats = solver.solve(logged=True)
        assert stats.status == mt.Status.INTERNAL_ERROR and not stats.success
        # rethrow_error=True: the exception propagates
        solver2 = mt.MPCSolver(
            qp, print_level=mt.PrintLevel.ERROR, rethrow_error=True
        )
        with pytest.raises(RuntimeError, match="synthetic failure"):
            solver2.solve(logged=True)


class TestTransformations:
    """Reference: test/runtests.jl:154-164."""

    def test_standard_form_objective(self, rng):
        n, m = 15, 6
        A = rng.standard_normal((m, n))
        x_int = rng.random(n) + 0.5
        mid = A @ x_int
        qp = mt.from_dense(
            c=rng.random(n) + 0.1,
            A=A,
            lcon=mid - rng.random(m),
            ucon=mid + rng.random(m),
            lvar=np.zeros(n),
            uvar=np.where(rng.random(n) < 0.5, 2.0, np.inf),
        )
        ref_stats = _solve(qp)
        sf = mt.standard_form(qp)
        assert np.all(sf.lcon == sf.ucon)  # equality-only
        stats = _solve(sf)
        assert stats.success
        assert stats.objective == pytest.approx(ref_stats.objective, abs=1e-6)

    def test_padding_invariance(self, rng):
        c, A, b, lvar, uvar = random_lp(rng, 10, 4, seed=23)
        qp = mt.from_dense(c=c, A=A, lcon=b, ucon=b, lvar=lvar, uvar=uvar)
        s64 = _solve(qp)  # default pad 128
        solver = mt.MPCSolver(qp, pad_multiple=256, print_level=mt.PrintLevel.ERROR)
        s256 = solver.solve()
        assert s256.iter == s64.iter
        assert s256.objective == pytest.approx(s64.objective, abs=1e-9)


class TestCheckResidual:
    """Linear-solve residual guardrail (reference solve_system! residual
    check + SolveException, src/linear_solver.jl:28-43)."""

    def _lp(self, seed=9):
        import madipm_tpu as mt

        rng = np.random.default_rng(seed)
        n, m = 30, 12
        A = rng.standard_normal((m, n))
        xs = rng.random(n) + 0.5
        b = A @ xs
        return mt.from_dense(
            c=rng.random(n) + 0.1, A=A, lcon=b, ucon=b,
            lvar=np.zeros(n), uvar=np.full(n, np.inf),
        )

    def test_clean_solve_passes(self):
        import madipm_tpu as mt

        s = mt.madipm(
            self._lp(), print_level=mt.PrintLevel.ERROR,
            check_residual=True, tol_linear_solve=1e-8,
        )
        assert s.success

    def test_unattainable_tolerance_flags_error(self):
        import madipm_tpu as mt

        s = mt.madipm(
            self._lp(), print_level=mt.PrintLevel.ERROR,
            check_residual=True, tol_linear_solve=1e-30,
        )
        assert s.status == mt.Status.ERROR_IN_STEP_COMPUTATION


class TestAdaptivePCGTol:
    def test_adaptive_tol_reaches_full_accuracy(self, rng):
        """pcg_adaptive_tol relaxes early inner solves (rtol ~ mu) but the
        clamp keeps late iterations tight enough for tol=1e-8; the final
        answer must match the fixed-tolerance solve."""
        import madipm_tpu as mt
        from conftest import random_lp

        c, A, b, lvar, uvar = random_lp(rng, n=40, m=12)
        qp = mt.from_dense(c=c, A=A, lcon=b, ucon=b, lvar=lvar, uvar=uvar)
        common = dict(
            print_level=mt.PrintLevel.ERROR,
            factor_dtype="float32",  # force the fp32-factor + PCG path on CPU
            refinement_steps=6,
        )
        ref = mt.madipm(qp, **common)
        ada = mt.madipm(qp, pcg_adaptive_tol=True, **common)
        assert ref.success and ada.success
        assert ada.objective == pytest.approx(ref.objective, abs=1e-7)


class TestFactorPrecision:
    @pytest.mark.parametrize("prec", ["default", "high", "highest"])
    def test_factor_precision_matches_full(self, rng, prec):
        """factor_precision relaxes the matmul precision of the fp32 factor /
        preconditioner path only — the fp64 PCG operator stays exact, so the
        converged answer must match the unrestricted solve.  (CPU executes
        every precision identically; this pins the plumbing + semantics.)"""
        import madipm_tpu as mt
        from conftest import random_lp

        c, A, b, lvar, uvar = random_lp(rng, n=40, m=12)
        qp = mt.from_dense(c=c, A=A, lcon=b, ucon=b, lvar=lvar, uvar=uvar)
        common = dict(
            print_level=mt.PrintLevel.ERROR,
            factor_dtype="float32",
            refinement_steps=6,
        )
        ref = mt.madipm(qp, **common)
        low = mt.madipm(qp, factor_precision=prec, **common)
        assert ref.success and low.success
        assert low.objective == pytest.approx(ref.objective, abs=1e-7)


class TestAcceptableLevel:
    def test_acceptable_exit_instead_of_max_iter(self, rng):
        """With an unreachable tol, the solver must settle at the acceptable
        level (MadNLP acceptable_tol/acceptable_iter semantics) instead of
        burning max_iter."""
        import madipm_tpu as mt
        from conftest import random_lp

        c, A, b, lvar, uvar = random_lp(rng, n=40, m=12)
        qp = mt.from_dense(c=c, A=A, lcon=b, ucon=b, lvar=lvar, uvar=uvar)
        stats = mt.madipm(
            qp,
            tol=1e-30,  # unattainable
            acceptable_tol=1e-6,
            acceptable_iter=3,
            max_iter=200,
            print_level=mt.PrintLevel.ERROR,
        )
        assert stats.status == mt.Status.SOLVED_TO_ACCEPTABLE_LEVEL
        assert stats.success
        assert stats.iter < 200
        assert max(stats.primal_feas, stats.dual_feas, stats.complementarity) <= 1e-6


class TestScaledAugmented:
    def test_k25_matches_default(self, rng):
        """K2.5 scaled augmented system reaches the same solution as plain K2
        (reference test: ScaledSparseKKTSystem vs default agreement,
        test/runtests.jl:107-120)."""
        import madipm_tpu as mt

        n, meq = 24, 8
        A = rng.standard_normal((meq, n))
        xstar = rng.random(n) + 0.5
        b = A @ xstar
        P = rng.standard_normal((n, n))
        Q = P.T @ P + np.eye(n)
        c = rng.random(n)
        qp = mt.from_dense(c=c, A=A, lcon=b, ucon=b, lvar=np.zeros(n),
                           uvar=np.full(n, np.inf), Q=Q)
        ref = mt.madipm(qp, print_level=mt.PrintLevel.ERROR)
        k25 = mt.madipm(qp, kkt_system=mt.KKTSystem.SCALED_AUGMENTED,
                        print_level=mt.PrintLevel.ERROR)
        assert ref.success and k25.success
        assert k25.objective == pytest.approx(ref.objective, rel=1e-7)
        assert np.allclose(k25.solution, ref.solution, atol=1e-5)

    def test_k25_lp(self, rng):
        import madipm_tpu as mt
        from conftest import random_lp

        c, A, b, lvar, uvar = random_lp(rng, n=30, m=10)
        qp = mt.from_dense(c=c, A=A, lcon=b, ucon=b, lvar=lvar, uvar=uvar)
        st = mt.madipm(qp, kkt_system=mt.KKTSystem.SCALED_AUGMENTED,
                       print_level=mt.PrintLevel.ERROR)
        ref = mt.madipm(qp, print_level=mt.PrintLevel.ERROR)
        assert st.success
        assert st.objective == pytest.approx(ref.objective, rel=1e-7)


class TestRankDeficient:
    """Linearly dependent equality rows: the factorization retry loop must
    rescue the singular normal matrix by pushing del_c toward the SPD-
    stabilizing sign (the reference's retry only multiplies, so its default
    FixedRegularization(1e-10, +1e-10) cannot recover — we can)."""

    def test_dependent_rows_default_options(self):
        # balanced transportation WITHOUT dropping the redundant row:
        # rank(A) = ns + nd - 1
        from madipm_tpu.models.generators import transportation_lp
        import scipy.sparse as sp

        mdl = transportation_lp(5, 7, seed=3)
        ns, nd = 5, 7
        # re-add the dropped demand row (sums of supplies - other demands)
        last_demand = np.zeros(mdl.nvar)
        last_demand[np.arange(nd - 1, mdl.nvar, nd)] = 1.0
        A = sp.vstack([mdl.A, sp.csr_matrix(last_demand)]).tocsr()
        bl = np.concatenate([mdl.lcon, [mdl.lcon[:ns].sum() - mdl.lcon[ns:].sum()]])
        full = mt.QuadraticModel(c=mdl.c, A=A, lcon=bl, ucon=bl,
                                 lvar=mdl.lvar, uvar=mdl.uvar)
        ref = mt.madipm(mdl, print_level=mt.PrintLevel.ERROR)
        st = mt.madipm(full, print_level=mt.PrintLevel.ERROR)  # defaults
        assert ref.success and st.success
        assert st.objective == pytest.approx(ref.objective, rel=1e-6)

    def test_dependent_rows_fp32_factor(self):
        # Regression for ops/kkt.PRECOND_SHIFT: with an fp32 factor + fp64
        # PCG (the mixed-precision route), rank-deficient rows leave the Jacobi-scaled
        # normal matrix singular up to del_c ~ 1e-8 and previously NaN'd
        # the step (ERROR_IN_STEP_COMPUTATION).  The preconditioner-only
        # 1e-6 shift must carry these to full tolerance.
        from madipm_tpu.models.generators import transportation_lp
        import scipy.sparse as sp

        ns, nd = 6, 9
        mdl = transportation_lp(ns, nd, seed=11)
        last_demand = np.zeros(mdl.nvar)
        last_demand[np.arange(nd - 1, mdl.nvar, nd)] = 1.0
        A = sp.vstack([mdl.A, sp.csr_matrix(last_demand)]).tocsr()
        bl = np.concatenate([mdl.lcon, [mdl.lcon[:ns].sum() - mdl.lcon[ns:].sum()]])
        full = mt.QuadraticModel(c=mdl.c, A=A, lcon=bl, ucon=bl,
                                 lvar=mdl.lvar, uvar=mdl.uvar)
        ref = mt.madipm(full, print_level=mt.PrintLevel.ERROR)  # fp64 factor
        st = mt.madipm(
            full,
            print_level=mt.PrintLevel.ERROR,
            regularization=mt.FixedRegularization(1e-8, -1e-8),
            linear_solver=mt.LinearSolver.CHOLESKY_INV,
            factor_dtype="float32",
            refinement_steps=6,
            pcg_adaptive_tol=True,
        )
        assert ref.success and st.success, (ref.status, st.status)
        assert st.objective == pytest.approx(ref.objective, rel=1e-6)
        assert st.primal_feas < 1e-8 and st.dual_feas < 1e-8


class TestKnownOptimum:
    """LPs with exactly-constructed primal-dual optimal pairs
    (models/generators.known_optimum_lp): correctness to rel-KKT <= 1e-8
    with NO oracle — the offline stand-in for the Netlib rel-KKT check
    (BASELINE.json north star)."""

    @staticmethod
    def _rel_kkt(qp, st):
        x, y, zl, zu = st.solution, st.multipliers, st.multipliers_L, st.multipliers_U
        A = qp.A.toarray()
        r_p = np.max(np.abs(A @ x - qp.lcon)) / max(1.0, np.max(np.abs(qp.lcon)))
        r_d = np.max(np.abs(qp.c + A.T @ y - zl + zu)) / max(1.0, np.max(np.abs(qp.c)))
        compl = np.max(np.abs(x * zl)) / max(1.0, np.max(np.abs(qp.c)))
        return max(r_p, r_d, compl)

    @pytest.mark.parametrize("m,n,deg", [(24, 64, False), (24, 64, True),
                                         (48, 128, True)])
    def test_exact_objective_and_kkt(self, m, n, deg):
        from madipm_tpu.models.generators import known_optimum_lp

        qp, info = known_optimum_lp(m, n, seed=m + n + deg, degenerate=deg)
        st = _solve(qp)
        assert st.success
        scale = max(1.0, abs(info["obj"]))
        assert abs(st.objective - info["obj"]) <= 1e-7 * scale
        assert self._rel_kkt(qp, st) <= 1e-7

    def test_fp32_factor_config(self):
        # the fp32-factor route must hit the same certificate
        from madipm_tpu.models.generators import known_optimum_lp

        qp, info = known_optimum_lp(32, 96, seed=5, degenerate=True)
        st = _solve(
            qp,
            linear_solver=mt.LinearSolver.CHOLESKY_INV,
            factor_dtype="float32",
            refinement_steps=6,
            pcg_adaptive_tol=True,
            regularization=mt.FixedRegularization(1e-8, -1e-8),
        )
        assert st.success
        assert abs(st.objective - info["obj"]) <= 1e-6 * max(1.0, abs(info["obj"]))
        assert self._rel_kkt(qp, st) <= 1e-6


class TestKnownOptimumQP:
    """Convex QPs with exactly-constructed KKT pairs
    (models/generators.known_optimum_qp): the Maros–Mészáros-role
    oracle-free rel-KKT evidence, through BOTH QP formulations (K2
    augmented, K1 condensed) and the sparse path (VERDICT round-2 #8)."""

    @staticmethod
    def _rel_kkt_qp(qp, st):
        x, y, zl, zu = st.solution, st.multipliers, st.multipliers_L, st.multipliers_U
        A = qp.A.toarray()
        r_p = np.max(np.abs(A @ x - qp.lcon)) / max(1.0, np.max(np.abs(qp.lcon)))
        r_d = qp.c + qp.Q @ x + A.T @ y - zl + zu
        r_d = np.max(np.abs(r_d)) / max(1.0, np.max(np.abs(qp.c)))
        sl = np.where(np.isfinite(qp.lvar), x - qp.lvar, 0.0)
        su = np.where(np.isfinite(qp.uvar), qp.uvar - x, 0.0)
        compl = max(np.max(np.abs(sl * zl)), np.max(np.abs(su * zu))) / max(
            1.0, np.max(np.abs(qp.c))
        )
        return max(r_p, r_d, compl)

    @pytest.mark.parametrize("kkt", ["AUGMENTED", "CONDENSED"])
    @pytest.mark.parametrize("deg", [False, True])
    def test_exact_objective_and_kkt(self, kkt, deg):
        from madipm_tpu.models.generators import known_optimum_qp

        qp, info = known_optimum_qp(20, 40, seed=11 + deg, degenerate=deg,
                                    sparse_q=True)
        st = _solve(qp, kkt_system=getattr(mt.KKTSystem, kkt))
        assert st.success, st.status
        scale = max(1.0, abs(info["obj"]))
        assert abs(st.objective - info["obj"]) <= 1e-6 * scale
        assert self._rel_kkt_qp(qp, st) <= 1e-6

    def test_sparse_k1_path(self):
        # The sparse device path (SparseDeviceQP + K1) must reach the same
        # certificate on a sparse-Hessian instance.
        from madipm_tpu.models.generators import known_optimum_qp

        qp, info = known_optimum_qp(24, 64, seed=21, density=0.15,
                                    sparse_q=True)
        st = _solve(qp, sparse=True, kkt_system=mt.KKTSystem.CONDENSED)
        assert st.success, st.status
        assert abs(st.objective - info["obj"]) <= 1e-6 * max(1.0, abs(info["obj"]))
        assert self._rel_kkt_qp(qp, st) <= 1e-6


class TestPredictorBudget:
    """predictor_pcg_budget (round-3 perf lever): the preconditioner-only
    affine solve must preserve convergence and objectives under the
    fp32-factor route."""

    @pytest.mark.parametrize("budget", [0, 2])
    def test_fp32_factor_convergence(self, budget):
        from tests.conftest import random_lp, scipy_linprog

        for seed in (31, 32):
            c, A, b, lv, uv = random_lp(None, 60, 20, seed=seed)
            qp = mt.from_dense(c=c, A=A, lcon=b, ucon=b, lvar=lv, uvar=uv)
            st = _solve(
                qp,
                linear_solver=mt.LinearSolver.CHOLESKY_INV,
                factor_dtype="float32",
                refinement_steps=12,
                pcg_adaptive_tol=True,
                predictor_pcg_budget=budget,
                regularization=mt.FixedRegularization(1e-8, -1e-8),
            )
            assert st.success, (seed, budget, st.status)
            ref = scipy_linprog(c, A, b, lv, uv)
            assert st.objective == pytest.approx(ref.fun, abs=2e-6 * (1 + abs(ref.fun)))

    def test_known_optimum_certificate(self):
        # The 1e-8 rel-KKT certificate must survive the cheap predictor.
        from madipm_tpu.models.generators import known_optimum_lp

        qp, info = known_optimum_lp(32, 96, seed=6, degenerate=True)
        st = _solve(
            qp,
            linear_solver=mt.LinearSolver.CHOLESKY_INV,
            factor_dtype="float32",
            refinement_steps=12,
            pcg_adaptive_tol=True,
            predictor_pcg_budget=0,
            regularization=mt.FixedRegularization(1e-8, -1e-8),
        )
        assert st.success
        assert abs(st.objective - info["obj"]) <= 1e-6 * max(1.0, abs(info["obj"]))
        assert TestKnownOptimum._rel_kkt(qp, st) <= 1e-6


class TestCorrectorTolCap:
    """pcg_tol_cap (round-3 perf experiment): loosening the corrector's
    adaptive-rtol upper clamp must not break convergence or the final
    certificate — the mu-proportional regime re-tightens the late phase
    regardless of the cap (solver/driver._direction_phase)."""

    @pytest.mark.parametrize("cap", [1e-9, 1e-6])
    def test_fp32_factor_convergence(self, cap):
        from tests.conftest import random_lp, scipy_linprog

        for seed in (41, 42):
            c, A, b, lv, uv = random_lp(None, 60, 20, seed=seed)
            qp = mt.from_dense(c=c, A=A, lcon=b, ucon=b, lvar=lv, uvar=uv)
            st = _solve(
                qp,
                linear_solver=mt.LinearSolver.CHOLESKY_INV,
                factor_dtype="float32",
                refinement_steps=12,
                pcg_adaptive_tol=True,
                predictor_pcg_budget=0,
                pcg_tol_cap=cap,
                regularization=mt.FixedRegularization(1e-8, -1e-8),
            )
            assert st.success, (seed, cap, st.status)
            ref = scipy_linprog(c, A, b, lv, uv)
            assert st.objective == pytest.approx(ref.fun, abs=2e-6 * (1 + abs(ref.fun)))

    def test_known_optimum_certificate_loose_cap(self):
        from madipm_tpu.models.generators import known_optimum_lp

        qp, info = known_optimum_lp(32, 96, seed=7, degenerate=True)
        st = _solve(
            qp,
            linear_solver=mt.LinearSolver.CHOLESKY_INV,
            factor_dtype="float32",
            refinement_steps=12,
            pcg_adaptive_tol=True,
            predictor_pcg_budget=0,
            pcg_tol_cap=1e-6,
            regularization=mt.FixedRegularization(1e-8, -1e-8),
        )
        assert st.success
        assert abs(st.objective - info["obj"]) <= 1e-6 * max(1.0, abs(info["obj"]))
        assert TestKnownOptimum._rel_kkt(qp, st) <= 1e-6


class TestCorrectorTolFloor:
    """pcg_tol_floor (round-5 perf experiment): raising the corrector's
    adaptive-rtol LOWER clamp from the historical 1e-13 stops the late-phase
    PCG over-solve — convergence and the
    known-optimum certificate must survive the loosened floor."""

    @pytest.mark.parametrize("floor", [1e-13, 1e-10])
    def test_fp32_factor_convergence(self, floor):
        from tests.conftest import random_lp, scipy_linprog

        for seed in (41, 43):
            c, A, b, lv, uv = random_lp(None, 60, 20, seed=seed)
            qp = mt.from_dense(c=c, A=A, lcon=b, ucon=b, lvar=lv, uvar=uv)
            st = _solve(
                qp,
                linear_solver=mt.LinearSolver.CHOLESKY_INV,
                factor_dtype="float32",
                refinement_steps=12,
                pcg_adaptive_tol=True,
                predictor_pcg_budget=0,
                pcg_tol_cap=1e-6,
                pcg_tol_floor=floor,
                regularization=mt.FixedRegularization(1e-8, -1e-8),
            )
            assert st.success, (seed, floor, st.status)
            ref = scipy_linprog(c, A, b, lv, uv)
            assert st.objective == pytest.approx(ref.fun, abs=2e-6 * (1 + abs(ref.fun)))

    def test_known_optimum_certificate_loose_floor(self):
        from madipm_tpu.models.generators import known_optimum_lp

        qp, info = known_optimum_lp(32, 96, seed=7, degenerate=True)
        st = _solve(
            qp,
            linear_solver=mt.LinearSolver.CHOLESKY_INV,
            factor_dtype="float32",
            refinement_steps=12,
            pcg_adaptive_tol=True,
            predictor_pcg_budget=0,
            pcg_tol_cap=1e-6,
            pcg_tol_floor=1e-10,
            regularization=mt.FixedRegularization(1e-8, -1e-8),
        )
        assert st.success
        assert abs(st.objective - info["obj"]) <= 1e-6 * max(1.0, abs(info["obj"]))
        assert TestKnownOptimum._rel_kkt(qp, st) <= 1e-6
