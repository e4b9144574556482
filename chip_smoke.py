#!/usr/bin/env python
"""Run the solver's main paths once on an NVIDIA GPU and check every result.

    python chip_smoke.py               # the one-card phases
    python chip_smoke.py --four-cards  # only the sharded paths, on four cards

Each phase drives the public entry points (``madipm``, ``MPCSolver``,
``madipm_batch``) at full width on data made from fixed seeds, compares the
result with a plain reference (the generator's exact optimum, HiGHS, or
``A @ x`` in fp64), and prints one line with its outcome and wall time
(compilation included).  A phase that fails prints its traceback and the
remaining phases still run; the script then exits 1 and prints no result
line.  Without a GPU it exits 2 before any phase runs: it has no CPU mode.

The last line of a passing run is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback
from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.abspath(__file__))
TRACE_DIR = os.path.join(REPO, ".trace", "chip_smoke")

#: the reference benchmark protocol (scripts/run_known_optimum.py, bench.py)
LP_OPTS = dict(tol=1e-8, max_iter=300)
#: rel-KKT bound: the solver's own tolerance.
KKT_TOL = 1e-8
#: objective error vs the exact optimum: degenerate instances are
#: objective-sensitive (2.7e-6 at rel-KKT 9.9e-9 on the CPU,
#: results/known-optimum-cpu.txt).
OBJ_TOL = 1e-5
#: objective gap vs HiGHS (both solve to ~1e-8; HiGHS's own tolerance).
HIGHS_TOL = 1e-6
#: the fp32-factor route the earlier benchmark forced: fp32 CHOLESKY_INV
#: preconditioner + fp64 PCG with mu-adaptive tolerances.
FP32_ROUTE = dict(
    factor_dtype="float32", refinement_steps=12, pcg_adaptive_tol=True,
    predictor_pcg_budget=0, pcg_tol_cap=1e-6, pcg_tol_floor=1e-8,
)


def log(msg: str) -> None:
    print(msg, flush=True)


def lp_opts(**extra):
    import madipm_tpu as mt

    return dict(
        LP_OPTS, regularization=mt.FixedRegularization(1e-8, -1e-8),
        print_level=mt.PrintLevel.ERROR, **extra,
    )


def known_lps(m: int, n: int, k: int):
    """``k`` known-optimum LPs, every second one degenerate (the seeds of
    scripts/run_known_optimum.py first)."""
    from madipm_tpu.models.generators import known_optimum_lp

    return [known_optimum_lp(m, n, seed=m + 1 + i // 2, degenerate=bool(i % 2))
            for i in range(k)]


def check_known(model, info, st, what: str = ""):
    """Raise unless ``st`` solved ``model`` to rel-KKT <= KKT_TOL with an
    objective within OBJ_TOL of the exact optimum; returns both numbers."""
    from scripts.run_known_optimum import rel_kkt

    kkt = rel_kkt(model, st)
    err = abs(st.objective - info["obj"]) / max(1.0, abs(info["obj"]))
    if not (st.success and kkt <= KKT_TOL and err <= OBJ_TOL):
        raise AssertionError(
            f"{what}{model.name}: status {st.status.name}, iter {st.iter}, "
            f"rel-KKT {kkt:.3e} (<= {KKT_TOL}), objective error {err:.3e} "
            f"(<= {OBJ_TOL})"
        )
    return kkt, err


def check_all_known(pairs, stats, what: str = ""):
    res = [check_known(mdl, info, st, what) for (mdl, info), st in zip(pairs, stats)]
    return max(r[0] for r in res), max(r[1] for r in res)


def highs_objective(model) -> float:
    from scipy.optimize import linprog

    bounds = [(lo if np.isfinite(lo) else None, up if np.isfinite(up) else None)
              for lo, up in zip(model.lvar, model.uvar)]
    res = linprog(model.c, A_eq=model.A, b_eq=model.lcon, bounds=bounds,
                  method="highs")
    if res.status != 0:
        raise AssertionError(f"HiGHS failed on {model.name}: {res.message}")
    return float(res.fun)


def check_highs(model, st) -> float:
    ref = highs_objective(model)
    gap = abs(st.objective - ref) / max(1.0, abs(ref))
    if not (st.success and gap <= HIGHS_TOL):
        raise AssertionError(
            f"{model.name}: status {st.status.name}, objective {st.objective!r} "
            f"vs HiGHS {ref!r}, gap {gap:.3e} (<= {HIGHS_TOL})"
        )
    return gap


def timed(fn, *args, reps: int = 1):
    """(seconds per call, result) of warm calls, synced on the result."""
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps, out


def batch_solve_time(models, **opts):
    """Warm device time of the vmapped solve of ``models`` (one jitted
    program, as madipm_batch runs it) and the lanes' iteration counts."""
    from madipm_tpu.parallel.batch import bucket_pad
    from madipm_tpu.solver import driver
    from madipm_tpu.utils.options import load_options

    probs, _ = bucket_pad(models)
    cfg = driver.make_config(load_options(**opts), is_qp=False)
    fn = jax.jit(jax.vmap(partial(driver.solve_device, cfg)))
    secs, (_, _, state) = timed(fn, probs)
    return secs, np.asarray(state.k)


def device_peaks(n: int):
    """Peak bytes in use on each of the first ``n`` devices."""
    return [d.memory_stats()["peak_bytes_in_use"] for d in jax.devices()[:n]]


def cholesky_time(k: int, m: int) -> float:
    """Warm time of one batched fp64 ``jnp.linalg.cholesky`` of k SPD m x m."""
    rng = np.random.default_rng(0)
    B = rng.standard_normal((k, m, m)) / np.sqrt(m)
    S = jnp.asarray(B @ np.swapaxes(B, 1, 2) + np.eye(m))
    secs, L = timed(jax.jit(jnp.linalg.cholesky), S, reps=10)
    if not bool(jnp.all(jnp.isfinite(L))):
        raise AssertionError("Cholesky of an SPD matrix failed")
    return secs


# ---------------------------------------------------------------------------
# one-card phases
# ---------------------------------------------------------------------------


def phase_lp_batch(m=1024, n=2048, k=8):
    from madipm_tpu.parallel import madipm_batch

    pairs = known_lps(m, n, k)
    stats = madipm_batch([p[0] for p in pairs], **lp_opts())
    kkt, err = check_all_known(pairs, stats)
    secs, iters = batch_solve_time([p[0] for p in pairs], **lp_opts())
    chol = cholesky_time(k, m)
    per_iter = secs / iters.max()
    return (f"{k}/{k} solved, iters {iters.tolist()}, worst rel-KKT {kkt:.3e}, "
            f"worst objective error {err:.3e}; warm solve {secs * 1e3:.2f} ms "
            f"= {per_iter * 1e3:.3f} ms per iteration; batched fp64 Cholesky "
            f"{k}x{m}^2 {chol * 1e3:.3f} ms = {chol / per_iter:.1%} of an iteration")


def phase_lp_suite(m=1024, n=2048, k=8, density=0.15):
    import bench
    import madipm_tpu as mt

    model = bench.make_suite(k=k, m=m, n=n, density=density)[0]
    st = mt.madipm(model, **lp_opts())
    gap = check_highs(model, st)
    return f"{model.name}: {st.iter} iters, objective gap vs HiGHS {gap:.3e}"


def phase_lp_large(m=4096, n=8192):
    import madipm_tpu as mt

    (model, info), = known_lps(m, n, 1)
    solver = mt.MPCSolver(model, **lp_opts())
    st = solver.solve()
    kkt, err = check_known(model, info, st)
    warm = solver.solve()
    per_iter = warm.solver_time / warm.iter
    chol = cholesky_time(1, m)
    return (f"{st.iter} iters, rel-KKT {kkt:.3e}, objective error {err:.3e}; "
            f"warm solve {warm.solver_time:.3f} s = {per_iter * 1e3:.3f} ms per "
            f"iteration; fp64 Cholesky {m}^2 {chol * 1e3:.3f} ms = "
            f"{chol / per_iter:.1%} of an iteration")


def phase_qp(m=1024, n=2048):
    import madipm_tpu as mt
    from madipm_tpu.models.generators import known_optimum_qp

    model, info = known_optimum_qp(m, n, seed=m + 1)
    out = []
    for kkt_system in (mt.KKTSystem.AUGMENTED, mt.KKTSystem.CONDENSED):
        st = mt.madipm(model, kkt_system=kkt_system, **lp_opts())
        kkt, err = check_known(model, info, st, f"{kkt_system.name} ")
        out.append(f"{kkt_system.name}: {st.iter} iters, rel-KKT {kkt:.3e}, "
                   f"objective error {err:.3e}")
    return "; ".join(out)


def phase_sparse(m=2048, n=32768, density=0.004):
    import bench
    import madipm_tpu as mt

    model = bench.make_suite(k=1, m=m, n=n, density=density)[0]
    st = mt.madipm(model, sparse=True, **lp_opts())
    gap = check_highs(model, st)
    return (f"nnz {model.A.nnz}: {st.iter} iters, objective gap vs HiGHS "
            f"{gap:.3e}")


def _failure_problem(m, n, duplicate, seed=0):
    import madipm_tpu as mt
    from madipm_tpu.models.qp import pad_to_device, slack_form

    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n))
    if duplicate:
        A[1] = A[0]  # a singular normal matrix: S - del_c I is indefinite
    b = A @ (rng.random(n) + 0.5)
    model = mt.from_dense(c=np.ones(n), A=A, lcon=b, ucon=b, lvar=np.zeros(n),
                          uvar=np.full(n, np.inf))
    return pad_to_device(slack_form(model))


def check_factor_failure(linear_solver, m=128, n=256):
    """The factor-failure contract: an indefinite matrix gives a not-ok
    factor, unbatched and per lane under vmap, and the factorize retry loop
    raises the regularization until the factor is ok."""
    from madipm_tpu.ops import block_chol, kkt, linalg
    from madipm_tpu.parallel.batch import stack_problems
    from madipm_tpu.utils.options import KKTSystem, LinearSolver

    if linear_solver == LinearSolver.CHOLESKY:
        factor = linalg.cholesky_factor
    else:
        factor = lambda S: block_chol.chol_inv(S)[0]  # noqa: E731
    is_ok = jax.jit(lambda S: linalg.cholesky_is_ok(factor(S)))
    rng = np.random.default_rng(1)
    Q, _ = np.linalg.qr(rng.standard_normal((m, m)))
    eig = np.linspace(1.0, 2.0, m)
    spd = (Q * eig) @ Q.T
    eig[m // 2] = -1e-3
    indefinite = (Q * eig) @ Q.T
    if bool(is_ok(jnp.asarray(indefinite))) or not bool(is_ok(jnp.asarray(spd))):
        raise AssertionError("cholesky_is_ok misreads a single factorization")
    lanes = np.asarray(jax.vmap(is_ok)(jnp.asarray(np.stack([spd, indefinite, spd]))))
    if lanes.tolist() != [True, False, True]:
        raise AssertionError(f"per-lane factor status {lanes.tolist()}")

    def factorize(trials, prob):
        cfg = kkt.KKTConfig(kind=KKTSystem.NORMAL, linear_solver=linear_solver,
                            factor_dtype=jnp.float64, refinement_steps=0,
                            max_factor_trials=trials)
        ones, zeros = jnp.ones(prob.n), jnp.zeros(prob.n)
        _, dw, dc, ok = kkt.factorize(cfg, prob, ones, zeros, zeros,
                                      jnp.asarray(1.0), jnp.asarray(1e-6))
        return ok, dw, dc

    healthy = _failure_problem(m, n, duplicate=False)
    singular = _failure_problem(m, n, duplicate=True)
    ok, _, dc = jax.jit(partial(factorize, 1))(singular)
    if bool(ok) or not np.isclose(float(dc), 1e-6):
        raise AssertionError(f"one trial on an indefinite system: ok={bool(ok)}, del_c={float(dc)}")
    ok, dw, dc = jax.jit(partial(factorize, 3))(singular)
    if not bool(ok) or not np.isclose(float(dc), -1e-4) or not np.isclose(float(dw), 100.0):
        raise AssertionError(
            f"retry: ok={bool(ok)}, del_w={float(dw)}, del_c={float(dc)} "
            "(expected ok, 100, -1e-4)")
    ok, _, dc = jax.jit(jax.vmap(partial(factorize, 3)))(stack_problems([healthy, singular]))
    if np.asarray(ok).tolist() != [True, True] or not np.allclose(dc, [1e-6, -1e-4]):
        raise AssertionError(f"vmapped retry: ok={np.asarray(ok)}, del_c={np.asarray(dc)}")


def phase_factor_failure():
    from madipm_tpu.utils.options import LinearSolver

    for ls in (LinearSolver.CHOLESKY, LinearSolver.CHOLESKY_INV):
        check_factor_failure(ls)
    return ("indefinite -> not ok (single and per lane); retry raises del_c "
            "1e-6 -> -1e-4, for CHOLESKY and CHOLESKY_INV")


def phase_fp32_route(m=1024, n=2048, k=8):
    import madipm_tpu as mt
    from madipm_tpu.parallel import madipm_batch

    pairs = known_lps(m, n, k)
    models = [p[0] for p in pairs]
    route = dict(FP32_ROUTE, linear_solver=mt.LinearSolver.CHOLESKY_INV)
    stats = madipm_batch(models, **lp_opts(**route))
    kkt, err = check_all_known(pairs, stats, "fp32 route ")
    t_def, it_def = batch_solve_time(models, **lp_opts())
    t_32, it_32 = batch_solve_time(models, **lp_opts(**route))
    return (f"{k}/{k} solved, worst rel-KKT {kkt:.3e}, worst objective error "
            f"{err:.3e}; warm batch: default {t_def * 1e3:.2f} ms "
            f"({it_def.sum()} iters, {it_def.sum() / t_def:.1f} iter/s), "
            f"fp32 CHOLESKY_INV {t_32 * 1e3:.2f} ms ({it_32.sum()} iters, "
            f"{it_32.sum() / t_32:.1f} iter/s)")


def phase_ozaki(m=1024, n=2048):
    from madipm_tpu.ops import ozaki

    (model, _), = known_lps(m, n, 1)
    A = model.A.toarray()
    rng = np.random.default_rng(3)
    x = rng.standard_normal(n)
    ref = A @ x
    scale = np.max(np.abs(A), axis=1) * np.max(np.abs(x)) * n
    Ad, xd = jnp.asarray(A), jnp.asarray(x)
    t_exact, _ = timed(jax.jit(jnp.matmul), Ad, xd, reps=100)
    out = [f"exact A@x {t_exact * 1e6:.2f} us"]
    for name, slicer, matvec in (
        ("ozaki", ozaki.slice_matrix, ozaki.matvec),
        ("ozaki_i8", ozaki.slice_matrix_i8, ozaki.matvec_i8),
    ):
        sm = jax.jit(slicer)(Ad)
        secs, y = timed(jax.jit(matvec), sm, xd, reps=100)
        err = float(np.max(np.abs(np.asarray(y)[:m] - ref) / scale))
        if not err < 2.0 ** -44:  # ops/ozaki.py N_SLICES bound
            raise AssertionError(f"{name}: scaled error {err:.3e} >= 2^-44")
        out.append(f"{name} {secs * 1e6:.2f} us (scaled error {err:.2e})")
    return ", ".join(out)


def phase_trace(m=1024, n=2048):
    import shutil

    import madipm_tpu as mt

    (model, info), = known_lps(m, n, 1)
    shutil.rmtree(TRACE_DIR, ignore_errors=True)
    st = mt.MPCSolver(model, **lp_opts()).solve(logged=False, trace_dir=TRACE_DIR)
    check_known(model, info, st)
    files = [os.path.join(d, f) for d, _, fs in os.walk(TRACE_DIR) for f in fs
             if f.endswith(".xplane.pb")]
    if not files:
        raise AssertionError(f"no .xplane.pb under {TRACE_DIR}")
    from jax.profiler import ProfileData

    data = ProfileData.from_file(files[0])
    device_events = sum(
        1 for plane in data.planes if plane.name.startswith("/device:GPU")
        for line in plane.lines for _ in line.events
    )
    if not device_events:
        raise AssertionError("the trace holds no GPU events: CUPTI is missing")
    return f"{os.path.getsize(files[0])} bytes, {device_events} GPU events"


ONE_CARD = [
    ("lp_batch", phase_lp_batch),
    ("lp_suite_highs", phase_lp_suite),
    ("lp_large", phase_lp_large),
    ("qp_k2_k1", phase_qp),
    ("sparse_ell", phase_sparse),
    ("factor_failure", phase_factor_failure),
    ("fp32_route", phase_fp32_route),
    ("ozaki", phase_ozaki),
    ("trace", phase_trace),
]


# ---------------------------------------------------------------------------
# four-card phases
# ---------------------------------------------------------------------------


def phase_four_batch(m=1024, n=2048, k=8, cards=4):
    """The 8-instance batch sharded over four cards against one card."""
    from madipm_tpu.parallel import madipm_batch, make_mesh

    pairs = known_lps(m, n, k)
    models = [p[0] for p in pairs]
    four = madipm_batch(models, mesh=make_mesh(cards), **lp_opts())
    # Each card held its shard: every device's peak use covers its lanes' A.
    lane_bytes = (k // cards) * m * n * 8
    peaks = device_peaks(cards)
    if min(peaks) < lane_bytes:
        raise AssertionError(f"peak bytes per device {peaks}: not every card "
                             f"held its {lane_bytes}-byte shard")
    one = madipm_batch(models, **lp_opts())
    for (mdl, _), a, b in zip(pairs, one, four):
        d_obj = abs(a.objective - b.objective) / max(1.0, abs(a.objective))
        if a.status != b.status or abs(a.iter - b.iter) > 1 or d_obj > 1e-8:
            raise AssertionError(
                f"{mdl.name}: one card {a.status.name}/{a.iter} it/{a.objective!r}, "
                f"{cards} cards {b.status.name}/{b.iter} it/{b.objective!r}")
    kkt, err = check_all_known(pairs, four, f"{cards} cards ")
    return (f"{k}/{k} match one card (status, iters +-1, objective 1e-8); "
            f"worst rel-KKT {kkt:.3e}; peak bytes per card {peaks}")


def _dist_compare(model, info, cards, **opts):
    import madipm_tpu as mt
    from madipm_tpu.parallel import make_mesh

    solver = mt.MPCSolver(model, mesh=make_mesh(cards, ("cols",)), **opts)
    held = len(solver.prob.A.sharding.device_set)
    if held != cards:
        raise AssertionError(f"A is held by {held} devices, not {cards}")
    dist = solver.solve()
    one = mt.madipm(model, **opts)
    kkt_d, _ = check_known(model, info, dist, f"{cards} cards ")
    kkt_1, _ = check_known(model, info, one, "one card ")
    d_obj = abs(dist.objective - one.objective) / max(1.0, abs(one.objective))
    if dist.status != one.status or d_obj > 1e-6:
        raise AssertionError(f"{model.name}: objectives differ by {d_obj:.3e}")
    return (f"{model.name}: {dist.iter} vs {one.iter} iters, rel-KKT "
            f"{kkt_d:.3e} vs {kkt_1:.3e}, objectives differ by {d_obj:.3e}")


def phase_four_dist(m=4096, n=8192, qm=1024, qn=2048, cards=4):
    """Distributed strip Cholesky (NORMAL LP and K1 QP) against one card."""
    import madipm_tpu as mt
    from madipm_tpu.models.generators import known_optimum_qp

    (lp, lp_info), = known_lps(m, n, 1)
    qp, qp_info = known_optimum_qp(qm, qn, seed=qm + 1)
    return "; ".join([
        _dist_compare(lp, lp_info, cards, **lp_opts()),
        _dist_compare(qp, qp_info, cards,
                      **lp_opts(kkt_system=mt.KKTSystem.CONDENSED)),
    ])


FOUR_CARDS = [
    ("four_card_batch", phase_four_batch),
    ("four_card_dist_factor", phase_four_dist),
]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded paths, on four cards")
    args = ap.parse_args()
    cards = 4 if args.four_cards else 1

    jax.config.update("jax_enable_x64", True)
    jax.config.update("jax_default_matmul_precision", "highest")
    if jax.default_backend() != "gpu":
        print(f"chip_smoke: JAX found no GPU (backend {jax.default_backend()!r}); "
              "this script has no CPU mode", file=sys.stderr)
        return 2
    devices = jax.devices()
    if len(devices) < cards:
        print(f"chip_smoke: needs {cards} GPUs, found {len(devices)}", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(f"nvidia-smi: {smi}")
    log(f"jax {jax.__version__}: {len(devices)} x {devices[0].device_kind}")

    failed = []
    for name, phase in FOUR_CARDS if args.four_cards else ONE_CARD:
        t0 = time.perf_counter()
        try:
            detail = phase()
        except Exception:  # noqa: BLE001 — report every phase, then fail
            traceback.print_exc()
            failed.append(name)
            log(f"phase {name}: FAILED ({time.perf_counter() - t0:.1f} s)")
            continue
        log(f"phase {name}: ok ({time.perf_counter() - t0:.1f} s) {detail}")
    if failed:
        log(f"chip_smoke: {len(failed)} phase(s) failed: {failed}")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
