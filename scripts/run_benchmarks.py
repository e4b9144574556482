#!/usr/bin/env python
"""Benchmark sweep runner — the reference's scripts/benchmarks_{cpu,gpu}.jl
equivalent (reference: scripts/benchmarks_gpu.jl:13-65).

Protocol per instance (identical to the reference's):
    import MPS (.mps/.sif, .gz, .bz2)  -> presolve -> Ruiz scaling
    -> standard form -> solve (max_iter=300, FixedRegularization(1e-8,-1e-8),
    tol=1e-8) -> record
    instance nvar ncon nnzj nnzh status iter objective total_time solver_time

Output: one TSV row per instance (the reference writes the same 10 columns,
scripts/benchmarks_gpu.jl:47-56 + instance name), consumed by
scripts/make_tables.py.

Two execution modes:
  --mode serial   one instance at a time (reference behavior; works on CPU)
  --mode batched  bucket instances by padded shape and solve each bucket as
                  ONE vmapped device program (the batched sweep,
                  parallel/batch.py) — per-instance wall time is then the
                  bucket time / bucket size.

With no instance directory, --synthetic N generates the self-measured
synthetic Netlib-scale suite (BASELINE.md protocol) so the harness runs in
air-gapped environments.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


MPS_EXTS = (".mps", ".sif", ".SIF", ".qps", ".mps.gz", ".sif.gz", ".mps.bz2", ".sif.bz2")


def find_instances(src: str, listing: str | None, excluded: set[str]):
    if listing:
        with open(listing) as f:
            names = [l.strip() for l in f if l.strip() and not l.startswith("#")]
        return [os.path.join(src, n) for n in names if n not in excluded]
    out = []
    for fn in sorted(os.listdir(src)):
        if fn.endswith(MPS_EXTS) and fn not in excluded:
            out.append(os.path.join(src, fn))
    return out


def _random_lp(rng, m, n, density, name):
    import madipm_tpu as mt

    A = rng.standard_normal((m, n)) * (rng.random((m, n)) < density)
    empty = np.flatnonzero(np.abs(A).sum(axis=1) == 0)
    for r in empty:
        A[r, rng.integers(n)] = 1.0
    xstar = rng.random(n) + 0.5
    b = A @ xstar
    uvar = np.full(n, np.inf)
    ub = rng.random(n) < 0.25
    uvar[ub] = xstar[ub] + 3 * rng.random(ub.sum())
    return mt.from_dense(
        c=rng.random(n) + 0.1, A=A, lcon=b, ucon=b,
        lvar=np.zeros(n), uvar=uvar, name=name,
    )


def _transport_lp(rng, ns, nd, name):
    """Transportation LP: ship from ns sources to nd sinks at min cost.

    The classic totally-unimodular network structure real Netlib
    instances are full of: 2 nonzeros per column, massive primal
    degeneracy — a stress test for step rules and bound-dual recovery
    rather than for the factorization."""
    import madipm_tpu as mt

    supply = rng.random(ns) + 0.5
    demand_w = rng.random(nd) + 0.5
    demand = demand_w / demand_w.sum() * supply.sum()
    n = ns * nd
    A = np.zeros((ns + nd, n))
    for i in range(ns):
        A[i, i * nd:(i + 1) * nd] = 1.0
    for j in range(nd):
        A[ns + j, j::nd] = 1.0
    b = np.concatenate([supply, demand])
    c = (rng.random((ns, nd)) + 0.1 + 0.5 * np.abs(
        np.arange(ns)[:, None] / ns - np.arange(nd)[None, :] / nd
    )).ravel()
    return mt.from_dense(
        c=c, A=A, lcon=b, ucon=b, lvar=np.zeros(n),
        uvar=np.full(n, np.inf), name=name,
    )


def _staircase_lp(rng, periods, nx, name):
    """Multiperiod staircase LP (production planning): block-banded A
    linking consecutive periods — the other canonical Netlib structure
    (long thin banded systems, moderate fill in the normal matrix)."""
    import madipm_tpu as mt

    m, n = periods * nx // 2, periods * nx
    A = np.zeros((m, n))
    rows_per = nx // 2
    for p in range(periods):
        r0, c0 = p * rows_per, p * nx
        blk = rng.standard_normal((rows_per, nx)) * (rng.random((rows_per, nx)) < 0.4)
        blk[np.abs(blk).sum(1) == 0, 0] = 1.0
        A[r0:r0 + rows_per, c0:c0 + nx] = blk
        if p + 1 < periods:  # coupling into the next period
            link = rng.standard_normal((rows_per, nx // 4)) * 0.5
            A[r0:r0 + rows_per, c0 + nx:c0 + nx + nx // 4] = link
    xstar = rng.random(n) + 0.5
    b = A @ xstar
    return mt.from_dense(
        c=rng.random(n) + 0.1, A=A, lcon=b, ucon=b, lvar=np.zeros(n),
        uvar=np.full(n, np.inf), name=name,
    )


def make_synthetic(k: int, seed0: int = 1234):
    """Feasible-by-construction LPs at Netlib scale (self-measured baseline
    per SURVEY §6: the reference repo publishes no numbers).

    Three families cycle: random sparse rows, transportation networks
    (totally unimodular, degenerate), and multiperiod staircases (banded)
    — the structures the Netlib suite is made of."""
    rng0 = np.random.default_rng(seed0)
    sizes = [(192, 384), (256, 512), (128, 256), (384, 768)]
    models = []
    for i in range(k):
        rng = np.random.default_rng(seed0 + i)
        fam = i % 3
        if fam == 0:
            m, n = sizes[i % len(sizes)]
            models.append(_random_lp(rng, m, n, 0.3, f"synth{i}"))
        elif fam == 1:
            ns, nd = 12 + 2 * (i % 4), 20 + 3 * (i % 5)
            models.append(_transport_lp(rng, ns, nd, f"transp{i}"))
        else:
            models.append(_staircase_lp(rng, 6 + (i % 3) * 2, 48, f"stair{i}"))
    return models


def make_synthetic_qp(k: int, seed0: int = 4321):
    """Feasible convex QPs (the Maros-Meszaros suite role,
    scripts/benchmarks_cpu.jl:66-70): random PSD Hessian + equality rows +
    bounds; solved with the AUGMENTED/K2 path."""
    import madipm_tpu as mt

    sizes = [(32, 96), (48, 128), (24, 64)]
    models = []
    for i in range(k):
        m, n = sizes[i % len(sizes)]
        rng = np.random.default_rng(seed0 + i)
        A = rng.standard_normal((m, n))
        xstar = rng.random(n) + 0.5
        b = A @ xstar
        P = rng.standard_normal((n, n // 2)) / np.sqrt(n)
        Q = P @ P.T + 0.1 * np.eye(n)
        uvar = np.full(n, np.inf)
        ub = rng.random(n) < 0.3
        uvar[ub] = xstar[ub] + rng.random(ub.sum())
        models.append(
            mt.from_dense(
                c=rng.standard_normal(n), A=A, lcon=b, ucon=b,
                lvar=np.zeros(n), uvar=uvar, Q=Q, name=f"synthqp{i}",
            )
        )
    return models


def prepare(model, reformulate: bool):
    """presolve -> Ruiz scale -> standard form (reference pipeline,
    scripts/benchmarks_gpu.jl:28-32)."""
    from madipm_tpu.models.presolve import presolve_qp
    from madipm_tpu.models.qp import standard_form
    from madipm_tpu.models.scale import scale_qp

    pre, flag, _post = presolve_qp(model)
    if not flag:
        return None  # already solved / infeasible / unbounded in presolve
    scaled, _ruiz = scale_qp(pre)
    return standard_form(scaled) if reformulate else scaled


def record_row(name, model, stats) -> str:
    """TSV row: instance nvar ncon nnzj nnzh status iter objective
    total_time linear_solver_time — the reference's 10 recorded fields
    (scripts/benchmarks_cpu.jl:42-50).  linear_solver_time is -1 when the
    run didn't use the timed driver (fused batched mode has no separable
    phases)."""
    nnzj = model.A.nnz if hasattr(model.A, "nnz") else int(np.count_nonzero(model.A))
    nnzh = 0
    if model.Q is not None:
        nnzh = model.Q.nnz if hasattr(model.Q, "nnz") else int(np.count_nonzero(model.Q))
    lin = stats.linear_solver_time
    cols = [
        name, model.nvar, model.ncon, nnzj, nnzh,
        int(stats.status), stats.iter, f"{stats.objective:.16e}",
        f"{stats.total_time:.6f}", f"{lin:.6f}" if lin is not None else "-1",
    ]
    return "\t".join(str(c) for c in cols)


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--src", help="directory of MPS/SIF instances (may be .gz/.bz2)")
    ap.add_argument("--probs", help="file listing instance filenames (one per line)")
    ap.add_argument("--exclude", help="file listing instances to skip")
    ap.add_argument("--synthetic", type=int, default=0, help="generate N synthetic LPs instead of reading --src")
    ap.add_argument("--synthetic-qp", type=int, default=0,
                    help="generate N synthetic convex QPs (Maros-Meszaros suite role)")
    ap.add_argument("--mode", choices=["serial", "batched"], default="serial")
    ap.add_argument("--out", default="benchmark-results.txt", help="output TSV path")
    ap.add_argument("--max-iter", type=int, default=300)
    ap.add_argument("--tol", type=float, default=1e-8)
    ap.add_argument("--no-reformulate", action="store_true",
                    help="skip standard-form reformulation (reference reformulate=false default)")
    ap.add_argument("--sparse", action="store_true",
                    help="use the ELL sparse Jacobian path (serial mode, LP only) "
                         "for large instances the dense padded layout can't hold")
    ap.add_argument("--cpu", action="store_true", help="force the CPU backend")
    ap.add_argument("--warmup", action="store_true",
                    help="serial mode: solve each instance twice and record "
                         "the SECOND (warm) time — excludes XLA compilation, "
                         "matching the reference protocol's timing semantics")
    ap.add_argument("--timed", action="store_true",
                    help="serial mode: run the phase-timed driver so each row "
                         "records linear_solver_time (reference "
                         "benchmarks_cpu.jl:50); adds per-phase host syncs")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import madipm_tpu as mt

    opts = dict(
        tol=args.tol,
        max_iter=args.max_iter,
        regularization=mt.FixedRegularization(1e-8, -1e-8),
        print_level=mt.PrintLevel.ERROR,
    )

    # --- Collect instances
    if args.synthetic or args.synthetic_qp:
        named_models = [(m.name, m) for m in make_synthetic(args.synthetic)] if args.synthetic else []
        if args.synthetic_qp:
            named_models += [(m.name, m) for m in make_synthetic_qp(args.synthetic_qp)]
    else:
        if not args.src:
            ap.error("--src or --synthetic required")
        excluded = set()
        if args.exclude:
            with open(args.exclude) as f:
                excluded = {l.strip() for l in f if l.strip()}
        paths = find_instances(args.src, args.probs, excluded)
        log(f"{len(paths)} instances from {args.src}")
        named_models = []
        for k, path in enumerate(paths):
            name = os.path.basename(path)
            log(f"{name} -- {k + 1} / {len(paths)}")
            try:
                named_models.append((name, mt.models.mps.read_mps(path)))
            except Exception as e:  # reference: @warn "Failed to import"
                log(f"failed to import {name}: {e}")

    # --- Transform
    prepared = []
    for name, model in named_models:
        try:
            p = prepare(model, reformulate=not args.no_reformulate)
        except Exception as e:
            log(f"failed to transform {name}: {e}")
            continue
        if p is None:
            log(f"{name}: solved in presolve, skipped")
            continue
        prepared.append((name, model, p))

    # --- Solve + record
    rows = []
    if args.mode == "serial":
        for name, model, p in prepared:
            try:
                solver = mt.MPCSolver(p, sparse=True if args.sparse else None, **opts)
                if args.warmup:
                    solver.solve(timed=args.timed)  # compile + warm caches
                stats = solver.solve(timed=args.timed)
                rows.append(record_row(name, p, stats))
                log(f"{name}: status={stats.status.name} iter={stats.iter} "
                    f"obj={stats.objective:.6e} time={stats.total_time:.3f}s")
            except Exception as e:
                log(f"failed to solve {name}: {e}")
                rows.append("\t".join([name] + ["0"] * 6 + ["nan", "-1", "-1"]))
    else:
        from collections import defaultdict

        from madipm_tpu.parallel.batch import madipm_batch

        buckets = defaultdict(list)
        pad = 128
        for item in prepared:
            p = item[2]
            key = (-(-p.ncon // pad), -(-(p.nvar) // pad))
            buckets[key].append(item)
        for key, items in sorted(buckets.items()):
            names = [i[0] for i in items]
            log(f"bucket {key}: {len(items)} instances ({', '.join(names[:5])}...)")
            t0 = time.time()
            stats_list = madipm_batch([i[2] for i in items], **opts)
            wall = time.time() - t0
            per = wall / len(items)
            for (name, _model, p), stats in zip(items, stats_list):
                stats.total_time = per
                stats.solver_time = per
                rows.append(record_row(name, p, stats))
                log(f"{name}: status={stats.status.name} iter={stats.iter} "
                    f"obj={stats.objective:.6e} (bucket {wall:.3f}s / {len(items)})")

    with open(args.out, "w") as f:
        f.write("\n".join(rows) + "\n")
    log(f"wrote {len(rows)} rows -> {args.out}")


if __name__ == "__main__":
    main()
