"""Worker process for the two-process multi-host CPU test (not collected
by pytest — driven by tests/test_multihost.py via subprocess).

Each of the 2 processes exposes 4 fake CPU devices, joins the
``jax.distributed`` runtime through ``mesh.init_distributed``, builds the
global 8-device (batch x cols) mesh with ``mesh.make_multihost_mesh``,
and runs ONE batched sharded solve of 4 identical-on-every-host LPs —
SURVEY §4's multi-HOST test recommendation, which the reference (strictly
single-process) has no analogue of.
"""

import os
import sys


def main():
    pid = int(sys.argv[1])
    port = sys.argv[2]
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

    import jax

    # Both processes run on the CPU (four virtual devices each), whatever
    # accelerator the host has: force it before any device use.
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    import numpy as np

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import madipm_tpu as mt
    from madipm_tpu.parallel.batch import madipm_batch
    from madipm_tpu.parallel.mesh import init_distributed, make_multihost_mesh

    idx = init_distributed(f"127.0.0.1:{port}", num_processes=2, process_id=pid)
    assert idx == pid, (idx, pid)
    assert jax.process_count() == 2, jax.process_count()
    assert jax.device_count() == 8, jax.device_count()
    assert jax.local_device_count() == 4, jax.local_device_count()

    mesh = make_multihost_mesh(axis_names=("batch", "cols"), cols=2)
    assert dict(mesh.shape) == {"batch": 4, "cols": 2}, mesh.shape

    # 4 instances, seeded identically on both hosts (global-data contract).
    models = []
    for s in range(4):
        rng = np.random.default_rng(900 + s)
        n, m = 16, 5
        A = rng.standard_normal((m, n))
        x = rng.random(n) + 0.5
        models.append(
            mt.from_dense(
                c=rng.random(n) + 0.1, A=A, lcon=A @ x, ucon=A @ x,
                lvar=np.zeros(n), uvar=np.full(n, np.inf),
            )
        )

    stats = madipm_batch(models, mesh=mesh, print_level=mt.PrintLevel.ERROR)
    assert len(stats) == 4
    for k, st in enumerate(stats):
        assert st.success, f"instance {k}: {st.status}"
    objs = " ".join(f"{st.objective:.12e}" for st in stats)
    # stdout contract checked by the spawning test: identical on both ranks.
    print(f"MULTIHOST_OK rank={pid} objs {objs}", flush=True)


if __name__ == "__main__":
    main()
