#!/usr/bin/env python3
"""Ground-truth reconstruction benchmark through the REAL product path.

For each L: synthesize a known confined-walk conformation
(chromosome3d.truth), derive its IF matrix (multiplicative noise, zero
dropout), run `run_pipeline` on it exactly as a user would (`run` CLI
semantics: text matrix at reference scale, binary .npy at scale — the
at-scale dispatch, device/streamed prep and assessment views all engage on
their own), then score the emitted rank01 model against the TRUE
coordinates (Kabsch mirror+scale RMSD / truth-distance Spearman /
relative dRMSD).

This is the at-scale analogue of the reference's golden-output regression
role (readme.txt:57-60, output_models/similarity.txt) and, at --sizes
49152, the end-to-end demonstration of the strip-streamed prep ceiling.

Usage (on the GPU; the work directory defaults to .gt_bench in the
checkout):
  python scripts/ground_truth_bench.py --sizes 456,2048,8192,24576 --models 4
  python scripts/ground_truth_bench.py --sizes 49152 --models 2 --bf16

Prints one JSON line per size plus a markdown table for DESIGN.md.
"""

import argparse
import glob
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="456,2048,8192")
    ap.add_argument("--models", type=int, default=4)
    ap.add_argument("--noise", type=float, default=0.1,
                    help="multiplicative IF noise sigma (lognormal)")
    ap.add_argument("--full", action="store_true",
                    help="full DGSA schedule (default: turbo)")
    ap.add_argument("--bf16", action="store_true",
                    help="pair_bf16 (bf16-STORED tiles) for at-scale sizes")
    ap.add_argument("--no-reports", action="store_true",
                    help="skip per-model violation report files (each an "
                         "O(L^2) host pass at scale)")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--work-dir", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".gt_bench"))
    args = ap.parse_args()

    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    if os.environ.get("JAX_PLATFORMS") == "cpu":
        jax.config.update("jax_platforms", "cpu")
    from chromosome3d.utils.cache import configure_compile_cache

    configure_compile_cache()

    import logging

    logging.basicConfig(level=logging.INFO)

    from chromosome3d.config import (
        AnnealConfig,
        PipelineConfig,
        turbo_anneal,
    )
    from chromosome3d.io.matrix import write_if_matrix
    from chromosome3d.io.pdb import read_ca_pdb
    from chromosome3d.pipeline import run_pipeline
    from chromosome3d.truth import (
        confined_walk,
        if_from_structure_strips,
        reconstruction_metrics,
    )

    os.makedirs(args.work_dir, exist_ok=True)
    rows = []
    for L in [int(s) for s in args.sizes.split(",") if s.strip()]:
        t0 = time.time()
        X = confined_walk(L, seed=L)
        t_truth = time.time() - t0

        # the product input: reference-format text at reference scale,
        # binary .npy (memmapped by the loader) at scale
        t0 = time.time()
        if L <= 768:
            M = if_from_structure_strips(X, alpha=0.5,
                                         noise_sigma=args.noise, seed=L)
            path = os.path.join(args.work_dir, f"chrGT_{L}_matrix.txt")
            write_if_matrix(path, M.astype(np.float64))
            del M
        else:
            path = os.path.join(args.work_dir, f"chrGT_{L}_matrix.npy")
            out = np.lib.format.open_memmap(
                path, mode="w+", dtype=np.float32, shape=(L, L)
            )
            if_from_structure_strips(X, alpha=0.5, noise_sigma=args.noise,
                                     seed=L, out=out)
            out.flush()
            del out
        t_if = time.time() - t0

        anneal = AnnealConfig(
            use_pallas=None,
            pair_bf16=bool(args.bf16 and L > 768),
        )
        if not args.full:
            anneal = turbo_anneal(anneal)
        cfg = PipelineConfig(model_count=args.models, anneal=anneal,
                             emit_violation_reports=not args.no_reports)

        t0 = time.time()
        out_dir = os.path.join(args.work_dir, f"out_{L}")
        summary = run_pipeline(path, out_dir, cfg)
        t_run = time.time() - t0

        (pdb,) = glob.glob(os.path.join(out_dir, "*rank01*.pdb"))
        met = reconstruction_metrics(read_ca_pdb(pdb), X)
        steps = anneal.total_steps
        row = {
            "L": L,
            "models": args.models,
            "schedule_steps": steps,
            "truth_s": round(t_truth, 1),
            "if_gen_s": round(t_if, 1),
            "run_s": round(t_run, 1),
            "solve_s": summary.get("phases", {}).get("solve_s"),
            "steps_per_sec": round(
                steps / max(
                    summary.get("phases", {}).get("solve_s") or t_run, 1e-9
                ), 1,
            ),
            "best_spearman_if_inv_d": summary["best_spearman_if_inv_d"],
            "bf16": bool(anneal.pair_bf16),
            "phases": summary.get("phases"),
            **{k: round(v, 5) if isinstance(v, float) else v
               for k, v in met.items()},
        }
        rows.append(row)
        print(json.dumps(row), flush=True)

    print("\n| L | run wall (s) | best Spearman(IF,1/d) | "
          "RMSD/Rg vs truth | Spearman(d, d_true) | dRMSD_rel |")
    print("|---|---|---|---|---|---|")
    for r in rows:
        print(
            f"| {r['L']} | {r['run_s']} | "
            f"{r['best_spearman_if_inv_d']:.4f} | "
            f"{r['rmsd_over_rg']:.4f} | {r['spearman_d']:.4f} | "
            f"{r['drmsd_rel']:.4f} |"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
