#!/usr/bin/env python3
"""Headline benchmark (BASELINE.json config 4): chr1_500kb (L=456), 10
restarts (20 annealed structures with enantiomer pairs), full DGSA-shaped
schedule, on the GPU.

Input: the reference's chr1_500kb matrix when CHROM3D_REFERENCE names a
checkout of the reference (its input/ and output_models/ directories);
otherwise a chromosome3d.truth structure of the same L with its IF matrix
(10% multiplicative noise, fixed seed).

Prints ONE JSON line:
  metric      anneal steps/sec on the chr1-500kb x10 ensemble (one "step" =
              one scheduled Langevin/Adam update of all 20 structures)
  vs_baseline our best model's Spearman(IF, 1/d) divided by the baseline
              model's: the published reference model
              (output_models/chr1_500kb_rank03_a11.pdb) with the reference
              input, the true structure with the synthetic one — >= 1.0
              means reconstruction quality matches or beats it.
Refuses to run (exit 1) where JAX finds no GPU.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip()


def _input(L=456):
    """(IF matrix, baseline coords, input name)."""
    ref = os.environ.get("CHROM3D_REFERENCE", "").strip()
    if ref and os.path.isdir(os.path.join(ref, "input")):
        from chromosome3d.io.matrix import load_if_matrix
        from chromosome3d.io.pdb import read_ca_pdb

        matrix = load_if_matrix(os.path.join(ref, "input", "chr1_500kb_matrix.txt"))
        base = read_ca_pdb(
            os.path.join(ref, "output_models", "chr1_500kb_rank03_a11.pdb")
        )
        return matrix, base, "reference chr1_500kb"
    from chromosome3d.truth import confined_walk, if_from_structure

    X = confined_walk(L, seed=1)
    return (if_from_structure(X, alpha=0.5, noise_sigma=0.1, seed=1), X,
            f"truth L={L} seed=1 noise=0.1")


def main() -> int:
    import jax

    from chromosome3d.utils.cache import configure_compile_cache

    configure_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py measures the GPU; JAX found {dev.platform}",
              file=sys.stderr)
        return 1

    from chromosome3d.config import AnnealConfig, RestraintConfig
    from chromosome3d.metrics import spearman_if_inv_d
    from chromosome3d.ops.energy import dense_restraints_from_numpy
    from chromosome3d.restraints import build_restraints
    from chromosome3d.solver.anneal import resolve_use_pallas, solve_ensemble_impl

    matrix, base_coords, source = _input()
    rc = RestraintConfig()  # alpha 0.5: the quality default (see PARITY.md)
    dense = dense_restraints_from_numpy(
        build_restraints(matrix, rc), rc.weighting, rc.weight_exponent
    )
    # pipeline restraints are exact (negdev = posdev = 0)
    cfg = AnnealConfig(exact_restraints=True)
    n_models = 10
    solve = jax.jit(lambda d, k: solve_ensemble_impl(d, cfg, k, n_models))
    t0 = time.perf_counter()
    solve = solve.lower(dense, jax.random.PRNGKey(0)).compile()
    compile_s = time.perf_counter() - t0
    jax.block_until_ready(solve(dense, jax.random.PRNGKey(0)))  # warm

    runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        result = solve(dense, jax.random.PRNGKey(82364))
        jax.block_until_ready(result)
        runs.append(time.perf_counter() - t0)
    wall = min(runs)
    coords = np.asarray(result.coords)

    n_structs = n_models * (2 if cfg.enantiomer else 1)
    steps_per_sec = cfg.total_steps / wall
    ours = max(spearman_if_inv_d(matrix, c) for c in coords)
    base = spearman_if_inv_d(matrix, base_coords)

    print(json.dumps({
        "metric": "anneal_steps_per_sec_chr1_500kb_x10",
        "value": round(steps_per_sec, 2),
        "unit": "ensemble_steps/s",
        "vs_baseline": round(ours / base, 4),
        "extra": {
            "platform": dev.platform,
            "device_kind": dev.device_kind,
            "card": _card(),
            "input": source,
            "pair_route": "kernel" if resolve_use_pallas(cfg) else "plain",
            "compile_seconds": round(compile_s, 3),
            "wall_seconds": round(wall, 4),
            "run_seconds": [round(r, 4) for r in runs],
            "schedule_steps": cfg.total_steps,
            "structures": n_structs,
            "structure_steps_per_sec": round(steps_per_sec * n_structs, 1),
            "best_spearman_if_inv_d": round(float(ours), 4),
            "baseline_spearman_if_inv_d": round(float(base), 4),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
