"""madipm_tpu — Mehrotra predictor-corrector LP/QP solver in JAX.

A from-scratch JAX/XLA framework with the capabilities of klamike/MadIPM.jl
(GPU interior-point solver for linear and convex quadratic programs), built
on dense batched linear algebra:

- the whole IPM iteration (KKT assembly, factorization, predictor/corrector
  solves, step lengths, barrier update) is one fused XLA program over padded
  dense arrays driven by ``lax.while_loop``;
- the per-iteration direct factorization (the reference's cuDSS role) is a
  dense fp64 Cholesky (cuSOLVER on the GPU) or a blocked LDL', with an
  optional fp32-factor + fp64-refinement route;
- scaling comes from ``vmap``/``shard_map`` batched solves and
  Schur-complement-partitioned KKT systems over a ``jax.sharding.Mesh``
  (parallel/), capabilities the single-device reference lacks.

Public API mirrors the reference exports (reference src/MadIPM.jl:19:
``MPCSolver``, ``madipm``) plus the strategy/option types.
"""

from .api import MPCSolver, madipm
from .modeling import Model
from .models.qp import DeviceQP, QuadraticModel, from_dense, pad_to_device, slack_form, standard_form
from .utils.options import (
    AdaptiveRegularization,
    AdaptiveStep,
    ConservativeStep,
    FixedRegularization,
    IPMOptions,
    KKTSystem,
    LinearSolver,
    Mehrotra,
    MehrotraAdaptiveStep,
    NoRegularization,
    PrintLevel,
    load_options,
)
from .utils.stats import IPMStats
from .utils.status import Status

__version__ = "0.1.0"

__all__ = [
    "MPCSolver",
    "madipm",
    "Model",
    "QuadraticModel",
    "DeviceQP",
    "from_dense",
    "slack_form",
    "standard_form",
    "pad_to_device",
    "IPMOptions",
    "load_options",
    "KKTSystem",
    "LinearSolver",
    "PrintLevel",
    "Status",
    "IPMStats",
    "Mehrotra",
    "ConservativeStep",
    "AdaptiveStep",
    "MehrotraAdaptiveStep",
    "NoRegularization",
    "FixedRegularization",
    "AdaptiveRegularization",
]
