#!/usr/bin/env python3
"""Compare a finished `chromosome3d genome` output tree against the
published reference models (the reference checkout named by
CHROM3D_REFERENCE): for every chromosome x resolution with a
shipped rankNN model, our run's best Spearman(IF, 1/d) (from the run's
own summary.json) vs the published model's score on the same matrix.

This is the PRODUCT-SURFACE twin of scripts/validate_genome.py (which
solves through the library API): point it at a real `genome` run and
it answers "did the production path beat the reference on every input"
without re-solving.

Usage: python scripts/check_genome_vs_published.py <genome_output_dir>
"""

import glob
import json
import os
import re
import sys

import numpy as np

REF = os.environ.get("CHROM3D_REFERENCE", "")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    if len(sys.argv) != 2:
        print(__doc__)
        return 2
    out_dir = sys.argv[1]
    with open(os.path.join(out_dir, "summary.json")) as f:
        summary = json.load(f)
    chroms = summary["chromosomes"]

    from chromosome3d.io.matrix import load_if_matrix
    from chromosome3d.io.pdb import read_ca_pdb
    from chromosome3d.metrics import spearman_if_inv_d

    refs = {}
    for p in glob.glob(os.path.join(REF, "output_models", "chr*_rank*_a11.pdb")):
        m = re.match(r"(chr\d+_(?:1mb|500kb))_rank\d+_a11\.pdb",
                     os.path.basename(p))
        if m:
            refs[m.group(1)] = p

    wins = total = 0
    rows = []
    for name in sorted(
        refs, key=lambda n: (int(re.match(r"chr(\d+)", n).group(1)), n)
    ):
        if name not in chroms:
            continue
        matrix = load_if_matrix(os.path.join(REF, "input", f"{name}_matrix.txt"))
        ref_score = spearman_if_inv_d(matrix, read_ca_pdb(refs[name]))
        ours = float(chroms[name]["best_spearman_if_inv_d"])
        win = ours > ref_score
        wins += win
        total += 1
        rows.append((name, ref_score, ours, "WIN" if win else "LOSS"))
        print(f"{name:14s} ref={ref_score:.4f} ours={ours:.4f} "
              f"{'WIN' if win else 'LOSS'}")
    print(f"== {wins}/{total} wins (run: {out_dir}, "
          f"wall {summary.get('wall_seconds')}s)")
    phases = summary.get("phases")
    if phases:
        print(json.dumps(phases, indent=1))
    return 0 if wins == total else 1


if __name__ == "__main__":
    sys.exit(main())
