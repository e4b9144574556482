"""Benchmark: batched IPM throughput on one GPU vs a serial CPU solve.

Protocol mirrors the reference benchmark harness (BASELINE.md,
scripts/benchmarks_gpu.jl:13-65): generate a suite of standard-form LPs at
Netlib scale, run presolve -> scaling -> standard form -> solve with
tol=1e-8, FixedRegularization(1e-8, -1e-8), max_iter=300, and record
per-instance status/iterations/objective/time.  The solver runs with the
library's default options.

Headline metric: total IPM iterations per second across the suite —
device path = all instances vmapped in ONE device program on one GPU;
baseline = scipy HiGHS IPM (a production CPU interior-point solver, playing
the reference's CPU/Ma57 role) solving the same instances serially.

Needs a GPU: without one it exits 2 and prints no result.  Prints ONE JSON
line to stdout:
  {"metric": ..., "value": ..., "unit": "iter/s", "vs_baseline": ...}
Diagnostics (the card's name and power limit among them) go to stderr.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

import jax


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def make_suite(k=16, n=384, m=192, density=0.3, seed0=1234):
    """Random sparse standard-form-ish LPs, feasible by construction."""
    import madipm_tpu as mt

    models = []
    for i in range(k):
        rng = np.random.default_rng(seed0 + i)
        A = rng.standard_normal((m, n)) * (rng.random((m, n)) < density)
        # keep rows nonempty
        empty = np.flatnonzero(np.abs(A).sum(axis=1) == 0)
        for r in empty:
            A[r, rng.integers(n)] = 1.0
        xstar = rng.random(n) + 0.5
        b = A @ xstar
        c = rng.random(n) + 0.1
        uvar = np.full(n, np.inf)
        ub_idx = rng.random(n) < 0.25
        uvar[ub_idx] = xstar[ub_idx] + 3 * rng.random(ub_idx.sum())
        models.append(
            mt.from_dense(
                c=c, A=A, lcon=b, ucon=b, lvar=np.zeros(n), uvar=uvar,
                name=f"synth{i}",
            )
        )
    return models


def bench_device(models, opts):
    """Vmapped single-program solve of the whole suite; returns
    (iters_total, wall_seconds, stats_list, exact_stats).  Compile excluded
    via warmup.  ``stats_list`` is the median timed run, whose right-hand
    sides are perturbed; ``exact_stats`` is the warmup run on the suite as
    generated, the one a reference solver can check."""
    from functools import partial

    from madipm_tpu.parallel.batch import bucket_pad, batched_stats
    from madipm_tpu.solver import driver
    from madipm_tpu.utils.options import load_options

    opt = load_options(**opts)
    probs, _ = bucket_pad(models)
    cfg = driver.make_config(opt, is_qp=False)

    import dataclasses as _dc

    # One jitted executable reused across runs (a fresh jax.jit wrapper per
    # call would retrace + recompile every time).  The rhs perturbation is a
    # traced scalar so repeated timed runs solve genuinely different
    # problems with zero additional host->device traffic.
    def _solve(probs_, bscale):
        p = _dc.replace(probs_, b=probs_.b * bscale)
        return jax.vmap(partial(driver.solve_device, cfg))(p)

    fn = jax.jit(_solve)
    probs = jax.block_until_ready(jax.device_put(probs))

    t0 = time.perf_counter()
    _, scale0, state0 = jax.block_until_ready(fn(probs, 1.0))
    log(f"device: first run (incl compile) {time.perf_counter() - t0:.1f}s")
    exact = batched_stats(models, scale0, state0, time.perf_counter() - t0)

    # Timed: R back-to-back solves with distinct rhs scalings.  The headline
    # is the MEDIAN of the per-run iters/wall ratios, pairing each run's
    # iteration count with ITS OWN wall time.
    R = 3
    walls = []
    iters_each = []
    for r in range(1, R + 1):
        t0 = time.perf_counter()
        _, scale, state = jax.block_until_ready(fn(probs, 1.0 + 1e-4 * r))
        walls.append(time.perf_counter() - t0)
        per_inst = np.asarray(state.k)
        iters_each.append(int(np.sum(per_inst)))
        log(f"device: run {r}: {walls[-1]:.3f}s, {iters_each[-1]} iters, "
            f"per-instance k={per_inst.tolist()}")
    rates = [i / w for i, w in zip(iters_each, walls)]
    log(f"device: per-run rates: {[f'{x:.1f}' for x in rates]}")
    med = int(np.argsort(rates)[len(rates) // 2])
    iters, wall = iters_each[med], walls[med]
    stats = batched_stats(models, scale, state, wall)
    return iters, wall, stats, exact


def bench_cpu_baseline(models):
    """HiGHS IPM on the same instances, serially (reference CPU role)."""
    from scipy.optimize import linprog

    total_iters = 0
    total_time = 0.0
    objs = []
    for mdl in models:
        bounds = [
            (l if np.isfinite(l) else None, u if np.isfinite(u) else None)
            for l, u in zip(mdl.lvar, mdl.uvar)
        ]
        t0 = time.time()
        res = linprog(
            mdl.c,
            A_eq=mdl.A.toarray(),
            b_eq=mdl.lcon,
            bounds=bounds,
            method="highs-ipm",
        )
        total_time += time.time() - t0
        total_iters += int(getattr(res, "nit", 0) or 0)
        objs.append(res.fun if res.status == 0 else np.nan)
    return total_iters, total_time, objs


def main() -> int:
    import subprocess

    jax.config.update("jax_enable_x64", True)
    jax.config.update("jax_default_matmul_precision", "highest")
    if jax.default_backend() != "gpu":
        log(f"bench: JAX found no GPU (backend {jax.default_backend()!r})")
        return 2
    from madipm_tpu.utils.cache import configure_cache

    configure_cache(jax, "gpu")
    dev = jax.devices()[0]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(f"device: {dev.device_kind} x {len(jax.devices())}; nvidia-smi: {smi}")

    k, n, m, density = 8, 2048, 1024, 0.15
    models = make_suite(k=k, n=n, m=m, density=density)

    import madipm_tpu as mt

    opts = dict(
        tol=1e-8,
        max_iter=300,
        regularization=mt.FixedRegularization(1e-8, -1e-8),
        print_level=mt.PrintLevel.ERROR,
    )
    iters, wall, stats, exact = bench_device(models, opts)
    solved = sum(s.success for s in stats)
    log(f"device: {solved}/{k} solved, {iters} total iters in {wall:.3f}s "
        f"-> {iters / wall:.1f} iter/s")

    cpu_iters, cpu_time, cpu_objs = bench_cpu_baseline(models)
    log(f"cpu(highs-ipm): {cpu_iters} iters in {cpu_time:.3f}s "
        f"-> {cpu_iters / max(cpu_time, 1e-9):.1f} iter/s")

    # Correctness cross-check, on the unperturbed solve (HiGHS solved the
    # suite as generated; the timed runs scale b by up to 1 + 3e-4).
    max_gap = 0.0
    for s, ref_obj in zip(exact, cpu_objs):
        if s.success and np.isfinite(ref_obj):
            max_gap = max(max_gap, abs(s.objective - ref_obj) / max(1.0, abs(ref_obj)))
    log(f"max relative objective gap vs HiGHS: {max_gap:.2e}")

    value = iters / wall
    baseline = cpu_iters / max(cpu_time, 1e-9)
    out = {
        "metric": f"ipm_iterations_per_sec_batch{k}_m{m}_n{n}",
        "value": round(value, 2),
        "unit": "iter/s",
        "vs_baseline": round(value / baseline, 3) if baseline > 0 else None,
        "solve_rate": solved / k,
        "max_rel_obj_gap": max_gap,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
