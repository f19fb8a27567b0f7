#!/usr/bin/env python3
"""CPU-mesh sanity curve for the row-sharded (sp) solver.

Runs the row-sharded ensemble solve at n_dev in {1, 2, 4, 8} on the
virtual CPU mesh (8 fake devices sharing the host's cores) at fixed
(L, B) and reports per-step wall normalized to n_dev=1. Absolute times
mean nothing here and are no device measurement; the SHAPE does: total
pair work is constant across n_dev (each shard computes its own rows
against all columns), the update replicates, so the normalized cost
should sit near 1.0 — strong growth with n_dev would mean the
collectives/glue add real per-step overhead.

Usage:
  python scripts/sp_mesh_curve.py [--L 2048] [--models 2] [--repeats 3]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
).strip()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--L", type=int, default=2048)
    ap.add_argument("--models", type=int, default=2)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    from chromosome3d.config import AnnealConfig, turbo_anneal
    from chromosome3d.ops.energy import DenseRestraints
    from chromosome3d.solver.sharded import solve_ensemble_sharded

    L = args.L
    rng = np.random.RandomState(L)
    t = np.abs(np.subtract.outer(np.arange(L), np.arange(L))).astype(float)
    target = (3.8 * t ** 0.6).astype(np.float32)
    mask = ((t >= 5) & (rng.rand(L, L) < 0.5)).astype(np.float32)
    mask = np.maximum(mask, mask.T)
    w = np.where(mask > 0, 1.0 / np.maximum(target, 1.0), 0.0).astype(np.float32)
    if mask.any():
        w = w / w[mask > 0].mean()
    dense = DenseRestraints(
        lo=jnp.asarray(target), hi=jnp.asarray(target),
        mask=jnp.asarray(mask), weight=jnp.asarray(w),
    )
    cfg = turbo_anneal(AnnealConfig(exact_restraints=True))
    steps = cfg.total_steps

    results = {}
    for n_dev in (1, 2, 4, 8):
        devs = np.asarray(jax.devices()[:n_dev])
        mesh = Mesh(devs, ("beads",))
        key = jax.random.PRNGKey(0)

        def run():
            res = solve_ensemble_sharded(mesh, dense, cfg, key, args.models)
            return np.asarray(res.coords)

        run()                                   # compile + warm
        best = float("inf")
        for _ in range(args.repeats):
            t0 = time.time()
            run()
            best = min(best, time.time() - t0)
        results[n_dev] = best
        print(f"n_dev={n_dev}: {best:.2f} s "
              f"({best / steps * 1e3:.2f} ms/step)", flush=True)

    base = results[1]
    print("\nnormalized per-step cost (CPU mesh, one physical core):")
    print("  n_dev " + "  ".join(f"{n:>6d}" for n in results))
    print("  rel   " + "  ".join(f"{results[n] / base:>6.2f}" for n in results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
