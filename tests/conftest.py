"""Test configuration: CPU backend, fp64, 8 virtual devices for sharding tests.

Mirrors the reference's test strategy (SURVEY §4): CPU differential and unit
tests, with multi-device sharding validated on a fake-device CPU mesh.
Tests marked ``gpu`` need the card (the analogue of the reference's
hardware-gated GPU suite, test/runtests.jl:204-206) and skip elsewhere; run
them on a GPU machine with
``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu -n 0``.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    flags = (flags + " --xla_force_host_platform_device_count=8").strip()
if "xla_cpu_parallel_codegen_split_count" not in flags:
    # jaxlib 0.9.0's XLA:CPU segfaults probabilistically in long processes
    # with hundreds of compiles (observed in backend_compile_and_load and
    # in executable (de)serialization; per-file pytest runs never crash).
    # Serializing the LLVM codegen split removes the threaded-codegen
    # trigger; see utils/cache.py for the related cache-disable.
    flags = (flags + " --xla_cpu_parallel_codegen_split_count=1").strip()
os.environ["XLA_FLAGS"] = flags

import jax

jax.config.update("jax_enable_x64", True)
jax.config.update("jax_default_matmul_precision", "highest")
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from madipm_tpu.utils.cache import configure_cache

# No persistent cache on CPU: jaxlib 0.9.0's XLA:CPU executable
# (de)serialization segfaults probabilistically in BOTH directions (see
# utils/cache.py) — the suite recompiles cold rather than crash
# intermittently.
configure_cache(jax, os.environ["JAX_PLATFORMS"].split(",")[0])

import numpy as np
import pytest
import scipy.sparse as sp


@pytest.fixture(autouse=True)
def _needs_gpu(request):
    """Skip ``gpu``-marked tests unless JAX's default device is a GPU.

    Decided here, at run time, so every xdist worker collects the same
    tests."""
    if request.node.get_closest_marker("gpu") and jax.default_backend() != "gpu":
        pytest.skip("needs a GPU; run with JAX_PLATFORMS=cuda on the card")


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def random_lp(rng, n, m, density=1.0, bounded_frac=1.0, upper_frac=0.3, seed=None):
    """Random feasible-by-construction LP with optional upper bounds.

    Builds A, picks an interior x* > 0 and sets b = A x*, so the problem is
    feasible; c >= 0 plus bounds keep it bounded below in practice (tests
    cross-check status against scipy/HiGHS rather than assuming).
    """
    if seed is not None:
        rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n))
    if density < 1.0:
        A *= rng.random((m, n)) < density
    xstar = rng.random(n) + 0.5
    b = A @ xstar
    c = rng.random(n) + 0.1
    lvar = np.zeros(n)
    uvar = np.full(n, np.inf)
    ub_idx = rng.random(n) < upper_frac
    uvar[ub_idx] = xstar[ub_idx] + rng.random(ub_idx.sum()) * 3.0
    return c, A, b, lvar, uvar


def scipy_linprog(c, A, b, lvar, uvar):
    from scipy.optimize import linprog

    bounds = [(l if np.isfinite(l) else None, u if np.isfinite(u) else None)
              for l, u in zip(lvar, uvar)]
    res = linprog(c, A_eq=A, b_eq=b, bounds=bounds, method="highs")
    return res
