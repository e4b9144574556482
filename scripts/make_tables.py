#!/usr/bin/env python
"""Comparison-table generator — the reference's
scripts/tables/generate_tables.jl equivalent.

Reads two TSVs written by scripts/run_benchmarks.py (e.g. a CPU run and a
GPU run), keeps instances where BOTH runs solved (the reference filters on
its solver's success status, generate_tables.jl:68-72), and emits a Markdown table
with per-instance total-time ratios plus summary statistics (solve rate,
iteration totals, shifted-geometric-mean times).

Usage: python scripts/make_tables.py results-cpu.txt results-gpu.txt [-o out.md]
"""

from __future__ import annotations

import argparse
import math
import sys

COLS = ["instance", "nvar", "ncon", "nnzj", "nnzh", "status", "iter",
        "objective", "total_time", "linear_solver_time"]

#: madipm_tpu.utils.status.Status values that count as "solved"
#: (SOLVE_SUCCEEDED, SOLVED_TO_ACCEPTABLE_LEVEL, PRESOLVE_SOLVED).
SOLVED = {2, 3, 18}


def read_tsv(path):
    rows = {}
    with open(path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) != len(COLS):
                continue
            d = dict(zip(COLS, parts))
            for k in ("nvar", "ncon", "nnzj", "nnzh", "status", "iter"):
                d[k] = int(float(d[k]))
            for k in ("objective", "total_time", "linear_solver_time"):
                d[k] = float(d[k])
            rows[d["instance"]] = d
    return rows


def sgm(times, shift=1.0):
    """Shifted geometric mean (standard LP-benchmark summary statistic)."""
    vals = [t for t in times if t >= 0]
    if not vals:
        return float("nan")
    return math.exp(sum(math.log(t + shift) for t in vals) / len(vals)) - shift


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("baseline", help="TSV of the baseline run (reference-CPU role)")
    ap.add_argument("candidate", help="TSV of the candidate run (GPU role)")
    ap.add_argument("-o", "--out", default=None, help="output Markdown path (default stdout)")
    ap.add_argument("--labels", nargs=2, default=("cpu", "gpu"))
    args = ap.parse_args()

    base = read_tsv(args.baseline)
    cand = read_tsv(args.candidate)
    lb, lc = args.labels

    common = sorted(set(base) & set(cand))
    both_solved = [k for k in common if base[k]["status"] in SOLVED and cand[k]["status"] in SOLVED]

    lines = []
    lines.append(f"| instance | nvar | ncon | nnzj | iter_{lb} | iter_{lc} | "
                 f"time_{lb} (s) | time_{lc} (s) | ratio |")
    lines.append("|---|---:|---:|---:|---:|---:|---:|---:|---:|")
    for k in both_solved:
        b, c = base[k], cand[k]
        ratio = b["total_time"] / c["total_time"] if c["total_time"] > 0 else float("inf")
        lines.append(
            f"| {k} | {b['nvar']} | {b['ncon']} | {b['nnzj']} | {b['iter']} | "
            f"{c['iter']} | {b['total_time']:.3f} | {c['total_time']:.3f} | {ratio:.2f} |"
        )

    nb = sum(1 for k in common if base[k]["status"] in SOLVED)
    nc = sum(1 for k in common if cand[k]["status"] in SOLVED)
    tb = sgm([base[k]["total_time"] for k in both_solved])
    tc = sgm([cand[k]["total_time"] for k in both_solved])
    summary = [
        "",
        f"**{len(common)} common instances; solved: {lb}={nb}, {lc}={nc}; "
        f"both={len(both_solved)}**",
        "",
        f"shifted-geomean total_time: {lb}={tb:.3f}s {lc}={tc:.3f}s "
        f"(ratio {tb / tc:.2f}x)" if both_solved else "no commonly-solved instances",
    ]
    # Linear-solver-time ratio — the reference's headline comparison
    # (generate_tables.jl:55-72 compares total AND linear-solver time).
    # Rows record -1 when the run didn't use the timed driver; only
    # instances timed on both sides enter.
    timed = [k for k in both_solved
             if base[k]["linear_solver_time"] >= 0 and cand[k]["linear_solver_time"] >= 0]
    if timed:
        lsb = sgm([base[k]["linear_solver_time"] for k in timed])
        lsc = sgm([cand[k]["linear_solver_time"] for k in timed])
        summary.append(
            f"shifted-geomean linear_solver_time ({len(timed)} timed): "
            f"{lb}={lsb:.3f}s {lc}={lsc:.3f}s (ratio {lsb / lsc:.2f}x)"
        )
    out = "\n".join(lines + summary) + "\n"
    if args.out:
        with open(args.out, "w") as f:
            f.write(out)
        print(f"wrote {args.out}", file=sys.stderr)
    else:
        sys.stdout.write(out)


if __name__ == "__main__":
    main()
