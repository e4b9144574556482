#!/usr/bin/env python
"""Known-optimum validation sweep (offline rel-KKT <= 1e-8 evidence).

Solves LPs with exactly-constructed primal-dual optimal pairs
(models/generators.known_optimum_lp) and records, per instance, the
objective error against the EXACT optimum and the relative KKT residual
of the returned primal-dual triple — no oracle solver involved.  This is
the air-gapped substitute for the reference protocol's "status==1 at
tol=1e-8 on Netlib" check (BASELINE.json north star).

Output TSV columns:
    instance  m  n  degenerate  status  iter  obj_err_rel  rel_kkt  time
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def rel_kkt(qp, st):
    x, y, zl, zu = st.solution, st.multipliers, st.multipliers_L, st.multipliers_U
    A = qp.A
    r_p = np.max(np.abs(A @ x - qp.lcon)) / max(1.0, np.max(np.abs(qp.lcon)))
    r_d = qp.c + A.T @ y - zl + zu
    if qp.Q is not None:
        r_d = r_d + qp.Q @ x
    r_d = np.max(np.abs(r_d)) / max(1.0, np.max(np.abs(qp.c)))
    sl = np.where(np.isfinite(qp.lvar), x - qp.lvar, 0.0)
    su = np.where(np.isfinite(qp.uvar), qp.uvar - x, 0.0)
    compl = max(np.max(np.abs(sl * zl)), np.max(np.abs(su * zu))) / max(
        1.0, np.max(np.abs(qp.c))
    )
    return max(float(r_p), float(r_d), float(compl))


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default="results/known-optimum.txt")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--sizes", default="128x256,256x512,512x1024,1024x2048")
    ap.add_argument(
        "--qp", action="store_true",
        help="sweep known-optimum convex QPs (Maros–Mészáros role) through "
             "BOTH the K2 augmented and K1 condensed formulations",
    )
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import madipm_tpu as mt
    from madipm_tpu.models.generators import known_optimum_lp, known_optimum_qp

    log(f"backend={jax.default_backend()}")

    opts = dict(
        tol=1e-8,
        max_iter=300,
        regularization=mt.FixedRegularization(1e-8, -1e-8),
        print_level=mt.PrintLevel.ERROR,
    )

    if args.qp:
        # Both QP formulations: K2 augmented LDL (the reference's default
        # SparseKKTSystem role) and K1 condensed (cuDSS-condensed role;
        # fp64 factor — gamma ~ 1e8 exceeds fp32 range, docs/design.md).
        configs = [
            ("k2", dict(kkt_system=mt.KKTSystem.AUGMENTED)),
            ("k1", dict(kkt_system=mt.KKTSystem.CONDENSED)),
        ]
    else:
        configs = [("", {})]

    rows = []
    worst_kkt, worst_obj = 0.0, 0.0
    n_solved = n_total = 0
    for size in args.sizes.split(","):
        m, n = (int(v) for v in size.split("x"))
        for deg in (False, True):
            for seed in (1, 2):
                if args.qp:
                    qp, info = known_optimum_qp(
                        m, n, seed=seed + m, degenerate=deg, sparse_q=True
                    )
                else:
                    qp, info = known_optimum_lp(m, n, seed=seed + m, degenerate=deg)
                for tag, extra in configs:
                    n_total += 1
                    st = mt.madipm(qp, **opts, **extra)
                    obj_err = abs(st.objective - info["obj"]) / max(1.0, abs(info["obj"]))
                    kkt = rel_kkt(qp, st)
                    rows.append(
                        f"{qp.name}_s{seed}{('_' + tag) if tag else ''}\t{m}\t{n}\t"
                        f"{int(deg)}\t{int(st.status)}\t"
                        f"{st.iter}\t{obj_err:.3e}\t{kkt:.3e}\t{st.total_time:.3f}"
                    )
                    log(rows[-1])
                    if st.success:
                        n_solved += 1
                        worst_kkt = max(worst_kkt, kkt)
                        worst_obj = max(worst_obj, obj_err)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write("\n".join(rows) + "\n")
    log(f"wrote {len(rows)} rows -> {args.out}")
    log(f"solved {n_solved}/{n_total}; worst rel-KKT {worst_kkt:.3e}, "
        f"worst rel obj err {worst_obj:.3e}")


if __name__ == "__main__":
    main()
