"""Cross-resolution similarity tooling.

Produces the `*_reduced.pdb` artifacts and the `similarity.txt` report the
reference ships in output_models/ (made there by an out-of-repo tool; the
protocol was reverse-engineered and verified in metrics.cross_resolution_
similarity: bead-pair-averaged reduction, distance-set Spearman, and
scale-optimal dRMSD — reproduces the published chr12/13/21 numbers).
"""

from __future__ import annotations

import glob as _glob
import os
import re
from typing import Dict, Optional, Tuple

from chromosome3d.io.pdb import read_ca_pdb, reduce_model, write_reduced_pdb
from chromosome3d.metrics import cross_resolution_similarity


def write_reduced_model(
    hi_res_pdb: str, out_pdb: Optional[str] = None, factor: int = 2
) -> str:
    """Emit the bead-pair-averaged reduced model of a high-res PDB, in the
    published chain-B/occ-0.20/b-10.00 reduced layout (io.pdb.write_reduced_pdb)."""
    coords = read_ca_pdb(hi_res_pdb)
    red = reduce_model(coords, factor)
    if out_pdb is None:
        out_pdb = hi_res_pdb.replace(".pdb", "_reduced.pdb")
    write_reduced_pdb(out_pdb, red)
    return out_pdb


def similarity_report(
    pairs: Dict[str, Tuple[str, str]], out_path: str, factor: int = 2
) -> Dict[str, Tuple[float, float]]:
    """Write a similarity.txt-format report.

    pairs: name -> (hi_res_pdb, lo_res_pdb). Emits per entry:
        <name>
        Spearman correlation: <rho>
        RMSD: <rmsd>
        <blank>
    matching output_models/similarity.txt:1-75. Returns the numbers."""
    results = {}
    with open(out_path, "w") as f:
        for name, (hi, lo) in pairs.items():
            rho, rmsd = cross_resolution_similarity(
                read_ca_pdb(hi), read_ca_pdb(lo), factor
            )
            results[name] = (rho, rmsd)
            f.write(f"{name}\n")
            f.write(f"Spearman correlation: {rho}\n")
            f.write(f"RMSD: {rmsd}\n\n")
    return results


def read_similarity_report(path: str) -> Dict[str, Tuple[float, float]]:
    """Parse a similarity.txt (ours or the published one) into
    {entry_name: (spearman, rmsd)} — entries are 'name\\nSpearman
    correlation: x\\nRMSD: y' blocks (output_models/similarity.txt:1-75)."""
    out: Dict[str, Tuple[float, float]] = {}
    name, rho = None, None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith("Spearman correlation:"):
                rho = float(line.split(":")[1])
            elif line.startswith("RMSD:"):
                if name is not None and rho is not None:
                    out.setdefault(name, (rho, float(line.split(":")[1])))
                name, rho = None, None
            else:
                name = line
    return out


def _fit_init_scale(x0: "np.ndarray", restraints) -> float:
    """Least-squares scale s minimizing sum over restrained pairs of
    (s*d0 - target)^2 — aligns a donor embedding with this resolution's
    restraint scale before annealing."""
    import numpy as np

    ii, jj = np.nonzero(np.triu(restraints.mask, k=1))
    if len(ii) == 0:
        return 1.0
    d0 = np.linalg.norm(x0[ii] - x0[jj], axis=-1)
    t = restraints.target[ii, jj]
    denom = float((d0 * d0).sum())
    return float((d0 * t).sum() / denom) if denom > 0 else 1.0


def solve_coinit(
    lo_matrix: "np.ndarray",
    hi_coords: "np.ndarray",
    cfg,
    factor: int = 2,
    seed: Optional[int] = None,
):
    """Solve the LOW-resolution chromosome co-initialized from the reduced
    HIGH-resolution model: x0 = bead-pair-averaged hi-res coords, scale-fit
    to the lo-res restraint targets, then the normal annealing ensemble.

    This couples the two resolutions' solutions the way the published
    similarity.txt protocol measures them (cross-resolution consistency),
    closing the one quality gap the independent solves left (chr21,
    output_models/similarity.txt:57-59). Returns (coords (n, L, 3),
    spearman_order, spearman_scores)."""
    import jax
    import numpy as np

    from chromosome3d.assess import rank_by_spearman
    from chromosome3d.pipeline import _bucket_pad, _padded_dense
    from chromosome3d.restraints import build_restraints
    from chromosome3d.solver.anneal import solve_ensemble

    rc = cfg.restraints
    L = lo_matrix.shape[0]
    restraints = build_restraints(lo_matrix, rc)
    red = reduce_model(np.asarray(hi_coords), factor)
    n = min(L, len(red))
    x0 = np.zeros((L, 3), np.float32)
    x0[:n] = red[:n]
    if L > n and n >= 2:
        step = red[n - 1] - red[n - 2]
        for i in range(n, L):
            x0[i] = x0[i - 1] + step
    x0 *= _fit_init_scale(x0, restraints)

    L_pad, bead_mask = _bucket_pad(L, cfg)
    dense, _ = _padded_dense(restraints, rc, L_pad)
    if L_pad != L:
        x0 = np.concatenate([x0, np.zeros((L_pad - L, 3), np.float32)])
    bm = None if bead_mask is None else jax.numpy.asarray(bead_mask)
    key = jax.random.PRNGKey(cfg.seed if seed is None else seed)
    res = solve_ensemble(
        dense, cfg.anneal, key, cfg.model_count, bm, jax.numpy.asarray(x0)
    )
    coords = np.asarray(res.coords)[:, :L, :]
    order, scores = rank_by_spearman(lo_matrix, coords, cfg.spearman_range)
    return coords, order, scores


def pair_outputs_by_chromosome(
    output_dir: str, hi_tag: str = "500kb", lo_tag: str = "1mb"
) -> Dict[str, Tuple[str, str]]:
    """Find best-model (rank01 or model1) PDBs for each chromosome at both
    resolutions under a run_genome output tree."""
    best: Dict[str, Dict[str, str]] = {}
    for sub in sorted(os.listdir(output_dir)):
        m = re.match(r"(chr\w+?)_(\w+)$", sub)
        if not m:
            continue
        chrom, res = m.groups()
        subdir = os.path.join(output_dir, sub)
        if not os.path.isdir(subdir):
            continue
        # rank files are tagged by the run's alpha (emit_artifacts: _rank01_a05
        # for the default alpha 0.5, _rank01_a11 for 1.1, ...) — glob the tag
        # rather than assuming one; fall back to the NOE-ranked model1 only
        # when no Spearman-ranked file exists.
        ranked = sorted(
            p
            for p in _glob.glob(os.path.join(subdir, f"{sub}_rank01_*.pdb"))
            if "_reduced" not in os.path.basename(p)
        )
        for path in ranked + [os.path.join(subdir, f"{sub}_model1.pdb")]:
            if os.path.exists(path):
                best.setdefault(chrom, {})[res] = path
                break
    pairs = {}
    for chrom, by_res in sorted(best.items()):
        if hi_tag in by_res and lo_tag in by_res:
            pairs[f"{chrom}_{hi_tag}_vs_{lo_tag}"] = (by_res[hi_tag], by_res[lo_tag])
    return pairs
