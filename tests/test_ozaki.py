"""Tests of the Ozaki error-free bf16-sliced fp64 matvec (ops/ozaki.py).

The reference runs fp64 natively on its GPUs (CUSPARSE SpMV operators,
ext/MadIPMCUDAExt/cuda_wrapper.jl:43-94); the slicing is an explicit
alternative (``fp64_matvec="ozaki"``) that evaluates the same operator
from low-precision dots.  These tests pin the EXACTNESS invariants the
scheme relies on — they hold on any backend because every rounding step
is explicit.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from madipm_tpu.ops import ozaki


class TestPow2Scale:
    def test_exact_powers_of_two(self, rng):
        mx = jnp.asarray(2.0 ** np.arange(-60.0, 61.0))
        s = np.asarray(ozaki._pow2_scale(mx))
        frac = np.log2(s)
        assert np.all(frac == np.round(frac)), "scales must be exact powers of two"
        mxn = np.asarray(mx)
        assert np.all(s > mxn)
        assert np.all(s <= 2.0 * mxn * (1 + 1e-6))

    def test_random_and_zero(self, rng):
        vals = np.abs(rng.standard_normal(500)) * np.exp(rng.uniform(-30, 30, 500))
        vals[::50] = 0.0
        s = np.asarray(ozaki._pow2_scale(jnp.asarray(vals)))
        nz = vals > 0
        assert np.all(s[nz] > vals[nz])
        assert np.all(s[~nz] == 1.0)
        frac = np.log2(s)
        assert np.all(frac == np.round(frac))


class TestSliceMatrix:
    def test_reconstruction_error_bound(self, rng):
        m, n = 128, 256
        A = rng.standard_normal((m, n)) * np.exp(rng.uniform(-6, 6, (m, 1)))
        sm = ozaki.slice_matrix(jnp.asarray(A))
        # sum of slices (in fp64) must reproduce A to 2^-8S relative to the
        # row scale.
        S, C, m_, ch = sm.slices.shape
        rec = np.asarray(sm.slices, np.float64).transpose(0, 2, 1, 3).reshape(S, m_, C * ch)
        rec = rec.sum(axis=0) * np.asarray(sm.row_scale)[:, None]
        bound = np.asarray(sm.row_scale)[:, None] * 2.0 ** (-8 * S)
        assert np.all(np.abs(rec[:, :n] - A) <= bound)

    def test_slices_are_bf16_exact_integers_scaled(self, rng):
        # every slice value times 2^{8(k+1)} must be an integer <= 2^8
        # (the error-free-accumulation precondition).
        A = rng.standard_normal((128, 128))
        sm = ozaki.slice_matrix(jnp.asarray(A))
        sl = np.asarray(sm.slices, np.float64)
        for k in range(sl.shape[0]):
            v = sl[k] * 2.0 ** (8 * (k + 1))
            assert np.all(v == np.round(v))
            assert np.max(np.abs(v)) <= 256


class TestMatvec:
    @pytest.mark.parametrize("shape", [(128, 128), (256, 512), (384, 128)])
    def test_accuracy_vs_fp64(self, rng, shape):
        m, n = shape
        A = rng.standard_normal((m, n)) * np.exp(rng.uniform(-8, 8, (m, 1)))
        x = rng.standard_normal(n) * np.exp(rng.uniform(-8, 8, n))
        sm = ozaki.slice_matrix(jnp.asarray(A))
        y = np.asarray(ozaki.matvec(sm, jnp.asarray(x)))
        y_ref = A @ x
        scale = np.max(np.abs(A), axis=1) * np.max(np.abs(x)) * n
        assert np.max(np.abs(y - y_ref) / scale) < 2.0 ** -44

    def test_exact_on_representable_data(self, rng):
        # powers of two with small integer combinations are reproduced
        # EXACTLY (every step error-free).
        A = np.zeros((128, 128))
        A[0, :] = 1.0
        A[1, :64] = 2.0 ** np.arange(-30, 34)
        A[2, 5] = 3.0
        x = np.ones(128)
        sm = ozaki.slice_matrix(jnp.asarray(A))
        y = np.asarray(ozaki.matvec(sm, jnp.asarray(x)))
        np.testing.assert_array_equal(y[:3], (A @ x)[:3])

    @pytest.mark.parametrize("n_slices", [2, 4, 6, 7, 8])
    def test_triangle_covers_every_needed_pair(self, rng, n_slices):
        # Regression: the rectangular triangle cover must include every
        # pair with s + t <= S - 1 for EVEN S too (an earlier [0, h-1)
        # bound dropped the s + t = S - 1 diagonal there, costing ~8 bits).
        m, n = 128, 256
        A = rng.standard_normal((m, n)) * np.exp(rng.uniform(-4, 4, (m, 1)))
        x = rng.standard_normal(n) * np.exp(rng.uniform(-4, 4, n))
        sm = ozaki.slice_matrix(jnp.asarray(A), n_slices=n_slices)
        y = np.asarray(ozaki.matvec(sm, jnp.asarray(x)))
        scale = np.max(np.abs(A), axis=1) * np.max(np.abs(x)) * n
        err = np.max(np.abs(y - A @ x) / scale)
        # truncation-level bound: ~2^{-8(S-1)} with generous slack, which
        # the dropped-diagonal bug violates by ~2^8.
        assert err < 2.0 ** (-8 * (n_slices - 1)) * 8

    def test_vmap_batches(self, rng):
        k, m, n = 3, 128, 256
        A = rng.standard_normal((k, m, n))
        x = rng.standard_normal((k, n))
        sm = jax.vmap(ozaki.slice_matrix)(jnp.asarray(A))
        y = np.asarray(jax.vmap(ozaki.matvec)(sm, jnp.asarray(x)))
        y_ref = np.einsum("kmn,kn->km", A, x)
        assert np.max(np.abs(y - y_ref)) < 1e-10 * np.max(np.abs(y_ref))


class TestMatvecT:
    """Transposed matvec from the FORWARD slices (ozaki.matvec_t): the
    shared-slice memory layout (halves the slice memory)."""

    @pytest.mark.parametrize("shape", [(128, 128), (256, 512), (384, 128)])
    def test_accuracy_vs_fp64(self, rng, shape):
        m, n = shape
        A = rng.standard_normal((m, n)) * np.exp(rng.uniform(-8, 8, (m, 1)))
        v = rng.standard_normal(m) * np.exp(rng.uniform(-8, 8, m))
        sm = ozaki.slice_matrix(jnp.asarray(A))
        y = np.asarray(ozaki.matvec_t(sm, jnp.asarray(v)))
        y_ref = A.T @ v
        scale = np.max(np.abs(A)) * np.max(np.abs(v)) * m
        assert np.max(np.abs(y[:n] - y_ref) / scale) < 2.0 ** -44

    def test_matches_stored_transpose(self, rng):
        m, n = 256, 384
        A = rng.standard_normal((m, n)) * np.exp(rng.uniform(-4, 4, (m, 1)))
        v = rng.standard_normal(m)
        sm = ozaki.slice_matrix(jnp.asarray(A))
        smT = ozaki.slice_matrix(jnp.asarray(A.T))
        y_shared = np.asarray(ozaki.matvec_t(sm, jnp.asarray(v)))
        y_stored = np.asarray(ozaki.matvec(smT, jnp.asarray(v)))
        ref = A.T @ v
        scale = np.max(np.abs(A)) * np.max(np.abs(v)) * m
        assert np.max(np.abs(y_shared[:n] - ref) / scale) < 2.0 ** -44
        assert np.max(np.abs(y_stored[:n] - ref) / scale) < 2.0 ** -44

    def test_i8_transpose(self, rng):
        m, n = 128, 192
        A = rng.standard_normal((m, n)) * np.exp(rng.uniform(-6, 6, (m, 1)))
        v = rng.standard_normal(m)
        sm = ozaki.slice_matrix_i8(jnp.asarray(A))
        y = np.asarray(ozaki.matvec_t_i8(sm, jnp.asarray(v)))
        ref = A.T @ v
        scale = np.max(np.abs(A)) * np.max(np.abs(v)) * m
        assert np.max(np.abs(y - ref) / scale) < 2.0 ** -44

    def test_solver_with_shared_slices(self, rng):
        import madipm_tpu as mt

        m, n = 40, 90
        A = np.asarray(rng.standard_normal((m, n)))
        b = A @ (rng.random(n) + 0.5)
        mdl = mt.from_dense(
            c=rng.random(n) + 0.1, A=A, lcon=b, ucon=b,
            lvar=np.zeros(n), uvar=np.full(n, np.inf),
        )
        common = dict(
            print_level=mt.PrintLevel.ERROR,
            linear_solver=mt.LinearSolver.CHOLESKY_INV,
            factor_dtype="float32",
            refinement_steps=6,
            fp64_matvec="ozaki",
        )
        st_two = mt.madipm(mdl, ozaki_share_slices=False, **common)
        st_one = mt.madipm(mdl, ozaki_share_slices=True, **common)
        assert st_two.success and st_one.success
        assert abs(st_one.objective - st_two.objective) <= 1e-8 * max(
            1.0, abs(st_two.objective)
        )


class TestMatvecI8:
    """int8-slice variant (ops/ozaki.py slice_matrix_i8/matvec_i8) — the
    same exactness invariants as the bf16 scheme, on int32 accumulation."""

    def test_slices_are_int8_range(self, rng):
        A = rng.standard_normal((64, 96)) * np.exp(rng.uniform(-6, 6, (64, 1)))
        sm = ozaki.slice_matrix_i8(jnp.asarray(A))
        assert sm.slices.dtype == jnp.int8
        sl = np.asarray(sm.slices, np.int64)
        assert np.max(np.abs(sl)) <= 64

    def test_reconstruction_error_bound(self, rng):
        A = rng.standard_normal((64, 96)) * np.exp(rng.uniform(-6, 6, (64, 1)))
        sm = ozaki.slice_matrix_i8(jnp.asarray(A))
        S = sm.slices.shape[0]
        w = 2.0 ** (-7.0 * (np.arange(S) + 1))
        rec = np.einsum(
            "smn,s->mn", np.asarray(sm.slices, np.float64), w
        ) * np.asarray(sm.row_scale)[:, None]
        bound = np.asarray(sm.row_scale)[:, None] * 2.0 ** (-7 * S)
        assert np.all(np.abs(rec - A) <= bound)

    @pytest.mark.parametrize("shape", [(128, 128), (256, 512), (384, 128)])
    def test_accuracy_vs_fp64(self, rng, shape):
        m, n = shape
        A = rng.standard_normal((m, n)) * np.exp(rng.uniform(-8, 8, (m, 1)))
        x = rng.standard_normal(n) * np.exp(rng.uniform(-8, 8, n))
        sm = ozaki.slice_matrix_i8(jnp.asarray(A))
        y = np.asarray(ozaki.matvec_i8(sm, jnp.asarray(x)))
        y_ref = A @ x
        scale = np.max(np.abs(A), axis=1) * np.max(np.abs(x)) * n
        # 8 slices x 7 bits = 56-bit grid, same as the bf16 S=7 scheme.
        assert np.max(np.abs(y - y_ref) / scale) < 2.0 ** -44

    def test_exact_on_representable_data(self, rng):
        A = np.zeros((128, 128))
        A[0, :] = 1.0
        A[1, :64] = 2.0 ** np.arange(-30, 34)
        A[2, 5] = 3.0
        x = np.ones(128)
        sm = ozaki.slice_matrix_i8(jnp.asarray(A))
        y = np.asarray(ozaki.matvec_i8(sm, jnp.asarray(x)))
        np.testing.assert_array_equal(y[:3], (A @ x)[:3])

    def test_rejects_overlong_x_and_contraction(self, rng):
        A = rng.standard_normal((8, 16))
        sm = ozaki.slice_matrix_i8(jnp.asarray(A))
        with pytest.raises(ValueError, match="matrix columns"):
            ozaki.matvec_i8(sm, jnp.ones(17))

    def test_vmap_batches(self, rng):
        k, m, n = 3, 64, 96
        A = rng.standard_normal((k, m, n))
        x = rng.standard_normal((k, n))
        sm = jax.vmap(ozaki.slice_matrix_i8)(jnp.asarray(A))
        y = np.asarray(jax.vmap(ozaki.matvec_i8)(sm, jnp.asarray(x)))
        y_ref = np.einsum("kmn,kn->km", A, x)
        assert np.max(np.abs(y - y_ref)) < 1e-10 * np.max(np.abs(y_ref))

    def test_dispatcher(self, rng):
        A = rng.standard_normal((64, 64))
        x = rng.standard_normal(64)
        for variant in ("bf16", "i8"):
            sm = ozaki.slice_any(jnp.asarray(A), variant)
            y = np.asarray(ozaki.apply(sm, jnp.asarray(x)))
            assert np.max(np.abs(y - A @ x)) < 1e-10


class TestSolverIntegration:
    def test_ozaki_solve_matches_emulated(self, rng):
        import madipm_tpu as mt

        m, n = 50, 100
        A = np.asarray(rng.standard_normal((m, n)) * (rng.random((m, n)) < 0.5))
        for r_ in np.flatnonzero(np.abs(A).sum(1) == 0):
            A[r_, int(rng.integers(n))] = 1.0
        b = A @ (rng.random(n) + 0.5)
        c = rng.random(n) + 0.1
        mdl = mt.from_dense(
            c=c, A=A, lcon=b, ucon=b, lvar=np.zeros(n), uvar=np.full(n, np.inf)
        )
        common = dict(
            tol=1e-8,
            regularization=mt.FixedRegularization(1e-8, -1e-8),
            print_level=mt.PrintLevel.ERROR,
            linear_solver=mt.LinearSolver.CHOLESKY_INV,
            factor_dtype="float32",
            refinement_steps=6,
            pcg_adaptive_tol=True,
        )
        st_em = mt.madipm(mdl, fp64_matvec="auto", **common)
        st_oz = mt.madipm(mdl, fp64_matvec="ozaki", **common)
        assert st_em.success and st_oz.success
        assert st_oz.iter <= st_em.iter + 2  # same iteration behavior
        assert abs(st_oz.objective - st_em.objective) <= 1e-8 * max(
            1.0, abs(st_em.objective)
        )
        assert st_oz.primal_feas < 1e-8 and st_oz.dual_feas < 1e-8
        # int8 variant: same solve through the i8 slices end to end.
        st_i8 = mt.madipm(mdl, fp64_matvec="ozaki_i8", **common)
        assert st_i8.success
        assert abs(st_i8.objective - st_em.objective) <= 1e-8 * max(
            1.0, abs(st_em.objective)
        )
        assert st_i8.primal_feas < 1e-8 and st_i8.dual_feas < 1e-8

    def test_ozaki_qp(self, rng):
        # convex QP: Q matvecs go through the Q slicing (AUGMENTED path).
        import madipm_tpu as mt

        m, n = 20, 40
        A = np.asarray(rng.standard_normal((m, n)))
        b = A @ (rng.random(n) + 0.5)
        c = rng.standard_normal(n)
        M = rng.standard_normal((n, n))
        Q = M @ M.T / n + np.eye(n)
        mdl = mt.from_dense(
            c=c, A=A, lcon=b, ucon=b, lvar=np.zeros(n),
            uvar=np.full(n, np.inf), Q=Q,
        )
        st_em = mt.madipm(mdl, fp64_matvec="auto", print_level=mt.PrintLevel.ERROR)
        st_oz = mt.madipm(mdl, fp64_matvec="ozaki", print_level=mt.PrintLevel.ERROR)
        assert st_em.success and st_oz.success
        assert abs(st_oz.objective - st_em.objective) <= 1e-7 * max(
            1.0, abs(st_em.objective)
        )


class TestSliceCountOption:
    """IPMOptions.ozaki_slices plumbing (5 slices = 25 instead of 49
    pass-pairs; library default stays 7)."""

    def test_with_ozaki_n_slices(self, rng):
        from madipm_tpu.models.qp import pad_to_device
        import madipm_tpu as mt

        n, m = 128, 128
        A = rng.standard_normal((m, n))
        x0 = rng.random(n) + 0.5
        qp = mt.from_dense(
            c=rng.random(n) + 0.1, A=A, lcon=A @ x0, ucon=A @ x0,
            lvar=np.zeros(n), uvar=np.full(n, np.inf),
        )
        prob = pad_to_device(qp)
        p5 = prob.with_ozaki("bf16", n_slices=5)
        assert p5.A_sl.slices.shape[0] == 5
        p_default = prob.with_ozaki("bf16")
        assert p_default.A_sl.slices.shape[0] == ozaki.N_SLICES
        # 5-slice operator stays well under the solver's 1e-8 needs.
        v = rng.standard_normal(prob.A.shape[1])
        y5 = np.asarray(ozaki.apply(p5.A_sl, jnp.asarray(v)))
        ref = np.asarray(prob.A) @ v
        scale = max(1.0, np.max(np.abs(ref)))
        assert np.max(np.abs(y5 - ref)) / scale < 1e-9

    def test_solver_option_end_to_end(self, rng):
        import madipm_tpu as mt
        from tests.conftest import random_lp, scipy_linprog

        c, A, b, lv, uv = random_lp(None, 60, 20, seed=77)
        qp = mt.from_dense(c=c, A=A, lcon=b, ucon=b, lvar=lv, uvar=uv)
        st = mt.madipm(
            qp, print_level=mt.PrintLevel.ERROR, fp64_matvec="ozaki",
            ozaki_slices=5, pcg_adaptive_tol=True, factor_dtype="float32",
            refinement_steps=12, linear_solver=mt.LinearSolver.CHOLESKY_INV,
            pcg_tol_floor=1e-8, pcg_tol_cap=1e-6, predictor_pcg_budget=0,
            regularization=mt.FixedRegularization(1e-8, -1e-8),
        )
        assert st.success
        ref = scipy_linprog(c, A, b, lv, uv)
        assert abs(st.objective - ref.fun) < 2e-6 * (1 + abs(ref.fun))


class TestMatvecSelection:
    """make_config's fp64_matvec resolution: "auto" never slices."""

    def test_auto_is_exact(self):
        from madipm_tpu.solver import driver
        from madipm_tpu.utils.options import load_options

        cfg = driver.make_config(load_options(), is_qp=False)
        assert not cfg.use_ozaki

    @pytest.mark.parametrize("choice,variant", [("ozaki", "bf16"), ("ozaki_i8", "i8")])
    def test_explicit_choice_accepted(self, choice, variant):
        from madipm_tpu.solver import driver
        from madipm_tpu.utils.options import load_options

        cfg = driver.make_config(load_options(fp64_matvec=choice), is_qp=False)
        assert cfg.use_ozaki and cfg.ozaki_variant == variant

    @pytest.mark.parametrize("choice", ["emulated", "exact"])
    def test_other_choice_rejected(self, choice):
        from madipm_tpu.solver import driver
        from madipm_tpu.utils.options import load_options

        with pytest.raises(ValueError, match="fp64_matvec must be 'auto'"):
            driver.make_config(load_options(fp64_matvec=choice), is_qp=False)
