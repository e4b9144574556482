"""The GPU entry points on a machine without a GPU, and chip_smoke's
comparison helpers on the CPU at a small size.

``bench.py`` and ``chip_smoke.py`` have no CPU mode: without a GPU they
must fail and print no result line."""

import dataclasses
import os
import subprocess
import sys

import pytest

import chip_smoke
import madipm_tpu as mt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_on_cpu(script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


def test_bench_fails_without_gpu():
    proc = _run_on_cpu("bench.py")
    assert proc.returncode != 0
    assert not [l for l in proc.stdout.splitlines() if l.lstrip().startswith("{")]
    assert "no GPU" in proc.stderr


def test_chip_smoke_fails_without_gpu():
    proc = _run_on_cpu("chip_smoke.py")
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "no GPU" in proc.stderr


def test_check_known_accepts_solve_and_rejects_wrong_objective():
    pairs = chip_smoke.known_lps(64, 128, 2)
    stats = [mt.madipm(model, **chip_smoke.lp_opts()) for model, _ in pairs]
    kkt, err = chip_smoke.check_all_known(pairs, stats)
    assert kkt <= chip_smoke.KKT_TOL and err <= chip_smoke.OBJ_TOL
    model, info = pairs[1]
    off = dataclasses.replace(stats[1], objective=info["obj"] * (1 + 1e-3) + 1e-3)
    with pytest.raises(AssertionError, match="objective error"):
        chip_smoke.check_known(model, info, off)
    unsolved = dataclasses.replace(stats[1], solution=stats[1].solution + 1e-3)
    with pytest.raises(AssertionError, match="rel-KKT"):
        chip_smoke.check_known(model, info, unsolved)


def test_check_highs_accepts_solve_and_rejects_gap():
    import bench

    model = bench.make_suite(k=1, m=64, n=128, density=0.3)[0]
    st = mt.madipm(model, **chip_smoke.lp_opts())
    assert chip_smoke.check_highs(model, st) <= chip_smoke.HIGHS_TOL
    off = dataclasses.replace(st, objective=st.objective * (1 + 1e-4) + 1e-4)
    with pytest.raises(AssertionError, match="HiGHS"):
        chip_smoke.check_highs(model, off)


def test_bench_cross_check_uses_unperturbed_solve():
    """bench.py's timed runs scale b; its HiGHS check must use the solve of
    the suite as generated, which agrees with HiGHS to the tolerance."""
    import bench

    models = bench.make_suite(k=2, m=64, n=128, density=0.3)
    opts = dict(chip_smoke.LP_OPTS, regularization=mt.FixedRegularization(1e-8, -1e-8),
                print_level=mt.PrintLevel.ERROR)
    _, _, timed, exact = bench.bench_device(models, opts)
    _, _, objs = bench.bench_cpu_baseline(models)

    def gap(stats):
        return max(abs(s.objective - o) / max(1.0, abs(o)) for s, o in zip(stats, objs))

    assert all(s.success for s in exact)
    assert gap(exact) <= chip_smoke.HIGHS_TOL < gap(timed)
