"""A x / A' y product-recurrence tests (round 4).

The fused drivers advance the memoized termination pair from
corrector-solve byproducts (``IPMOptions.product_recurrence``, default
True) instead of recomputing both A-applications per trip.  These pin:

  * the PCG residual byproduct is the true residual of the returned
    iterate (``linalg.pcg(return_residual=True)``),
  * ``solve_condensed(return_products=True)`` returns exact ``A dx`` /
    ``A' dy`` on the NORMAL fp64-PCG path (the byproduct fast path) and
    the K1 path (the explicit fallback),
  * recurrence on/off solve parity: equal statuses, equal iteration
    counts (+-1), objectives to 1e-7 under the fp32-factor
    config (drift bounded by the CERT_PERIOD exact resync).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import madipm_tpu as mt
from madipm_tpu.ops import linalg
from tests.conftest import random_lp


class TestPCGResidual:
    def test_residual_matches_iterate(self):
        rng = np.random.default_rng(3)
        n = 48
        B = rng.normal(size=(n, n))
        S = B @ B.T + 0.5 * np.eye(n)
        Sj = jnp.asarray(S)
        # deliberately crude preconditioner so the PCG actually iterates
        P = jnp.asarray(np.diag(1.0 / np.diag(S)))
        rhs = jnp.asarray(rng.normal(size=n))
        x, r = linalg.pcg(
            lambda b: P @ b, lambda v: Sj @ v, rhs,
            max_iters=200, rtol=1e-12, return_residual=True,
        )
        true_r = rhs - Sj @ x
        # The tracked residual must MATCH the returned iterate (that is
        # what the driver recurrence consumes); recursive drift is O(eps)
        # per iteration.  Absolute convergence depends on the (crude)
        # Jacobi preconditioner and is not the property under test.
        assert float(jnp.max(jnp.abs(r - true_r))) <= 1e-9 * float(
            jnp.max(jnp.abs(rhs))
        )

    def test_exit_at_r0_is_exact(self):
        # strong preconditioner -> exit at the initial residual check,
        # where the tracked residual is exact by construction
        rng = np.random.default_rng(4)
        n = 32
        B = rng.normal(size=(n, n))
        S = B @ B.T + 0.5 * np.eye(n)
        Sj = jnp.asarray(S)
        Sinv = jnp.asarray(np.linalg.inv(S))
        rhs = jnp.asarray(rng.normal(size=n))
        x, r = linalg.pcg(
            lambda b: Sinv @ b, lambda v: Sj @ v, rhs,
            max_iters=10, rtol=1e-10, return_residual=True,
        )
        np.testing.assert_allclose(
            np.asarray(r), np.asarray(rhs - Sj @ x), atol=1e-12
        )


def _products_case(kkt_system, **extra):
    """Solve a small LP, then re-run one solve_condensed with
    return_products and check the products against explicit matvecs."""
    import dataclasses
    from functools import partial

    from madipm_tpu.models.qp import pad_to_device
    from madipm_tpu.solver import driver
    from madipm_tpu.ops import kkt as kkt_ops

    c, A, b, lv, uv = random_lp(None, 40, 16, seed=7)
    qp = mt.from_dense(c=c, A=A, lcon=b, ucon=b, lvar=lv, uvar=uv)
    opt = mt.load_options(
        tol=1e-8,
        print_level=mt.PrintLevel.ERROR,
        kkt_system=kkt_system,
        regularization=mt.FixedRegularization(1e-8, -1e-8),
        **extra,
    )
    prob = pad_to_device(qp)
    cfg = driver.make_config(opt, is_qp=False)
    prob_s, scale, st = jax.jit(partial(driver.initialize, cfg))(prob)
    # a few iterations in, so Sigma is nontrivial
    step = jax.jit(partial(driver.iteration, cfg))
    for _ in range(3):
        st = step(prob_s, st)
    pb = dataclasses.replace(prob_s, lb=st.lb, ub=st.ub)
    factors, *_ = kkt_ops.factorize(
        cfg.kkt, pb, st.x, st.zl, st.zu, st.del_w, st.del_c
    )
    rng = np.random.default_rng(11)
    rx = jnp.asarray(rng.normal(size=prob.n))
    rp = jnp.where(pb.row_mask, jnp.asarray(rng.normal(size=prob.m)), 0.0)
    dx, dy, adx, atdy = kkt_ops.solve_condensed(
        cfg.kkt, pb, factors, rx, rp, return_products=True
    )
    dx2, dy2 = kkt_ops.solve_condensed(cfg.kkt, pb, factors, rx, rp)
    np.testing.assert_allclose(np.asarray(dx), np.asarray(dx2), rtol=1e-12, atol=1e-14)
    scale_a = max(1.0, float(jnp.max(jnp.abs(adx))))
    np.testing.assert_allclose(
        np.asarray(adx), np.asarray(pb.matvec(dx)),
        atol=1e-9 * scale_a, rtol=1e-9,
    )
    np.testing.assert_allclose(
        np.asarray(atdy), np.asarray(pb.rmatvec(dy)), rtol=1e-12, atol=1e-12
    )


class TestSolveProducts:
    def test_normal_pcg_byproduct_path(self):
        # fp32 factor + fp64 PCG: A dx comes from the tracked residual
        _products_case(
            mt.KKTSystem.NORMAL,
            linear_solver=mt.LinearSolver.CHOLESKY_INV,
            factor_dtype="float32",
            refinement_steps=12,
        )

    def test_normal_direct_fallback(self):
        # fp64 direct solve: explicit-product fallback
        _products_case(mt.KKTSystem.NORMAL, refinement_steps=0)

    def test_k1_fallback(self):
        _products_case(
            mt.KKTSystem.CONDENSED,
            linear_solver=mt.LinearSolver.CHOLESKY_INV,
        )


class TestRecurrenceParity:
    @pytest.mark.parametrize("seed", [41, 42, 43])
    def test_fp32_factor_parity(self, seed):
        c, A, b, lv, uv = random_lp(None, 60, 24, seed=seed)
        qp = mt.from_dense(c=c, A=A, lcon=b, ucon=b, lvar=lv, uvar=uv)
        common = dict(
            tol=1e-8,
            print_level=mt.PrintLevel.ERROR,
            linear_solver=mt.LinearSolver.CHOLESKY_INV,
            factor_dtype="float32",
            refinement_steps=12,
            pcg_adaptive_tol=True,
            predictor_pcg_budget=0,
            pcg_tol_cap=1e-6,
            regularization=mt.FixedRegularization(1e-8, -1e-8),
        )
        on = mt.madipm(qp, product_recurrence=True, **common)
        off = mt.madipm(qp, product_recurrence=False, **common)
        assert on.success and off.success, (on.status, off.status)
        assert abs(on.iter - off.iter) <= 1
        scale = max(1.0, abs(off.objective))
        assert abs(on.objective - off.objective) <= 1e-7 * scale

    def test_infeasible_classification_preserved(self):
        # the recurrence must not break the stall/infeasibility detectors
        A = np.array([[1.0, 1.0], [1.0, 1.0]])
        b = np.array([1.0, 3.0])
        qp = mt.from_dense(
            c=[1.0, 1.0], A=A, lcon=b, ucon=b,
            lvar=[0.0, 0.0], uvar=[np.inf] * 2,
        )
        st = mt.madipm(qp, print_level=mt.PrintLevel.ERROR,
                       product_recurrence=True)
        assert not st.success
