"""Hyperparameter-ensemble quality mode tests."""

import os

import pytest

from chromosome3d.config import AnnealConfig, PipelineConfig, RestraintConfig, fast_anneal

REF_INPUT = "/root/reference/input"


def test_pipeline_alpha_ensemble(tmp_path):
    from chromosome3d.io.pdb import read_pdb_remarks
    from chromosome3d.pipeline import run_pipeline

    src = os.path.join(REF_INPUT, "chr22_1mb_matrix.txt")
    if not os.path.exists(src):
        pytest.skip("reference not available")
    cfg = PipelineConfig(
        model_count=2,
        restraints=RestraintConfig(alpha=0.5),
        anneal=fast_anneal(AnnealConfig()),
        alpha_ensemble=(0.7,),
    )
    out = str(tmp_path / "out")
    summary = run_pipeline(src, out, cfg)
    # 2 models per alpha -> 4 rank files
    ranks = sorted(p for p in os.listdir(out) if "_rank" in p)
    assert len(ranks) == 4
    alphas = {read_pdb_remarks(os.path.join(out, p)).get("alpha") for p in ranks}
    assert alphas == {0.5, 0.7}
    # NOE top-k only from the base alpha: model files still top_k-limited
    models = [p for p in os.listdir(out) if "_model" in p and p.endswith(".pdb")]
    assert len(models) == 2


def test_cli_alpha_ensemble_parsing():
    from chromosome3d.cli import _make_config
    import argparse

    ns = argparse.Namespace(
        kscaling=11.0, alpha=0.5, model_count=4, fast=True, pallas=False,
        alpha_ensemble="0.7, 0.9",
    )
    cfg = _make_config(ns)
    assert cfg.alpha_ensemble == (0.7, 0.9)


def test_genome_alpha_ensemble(tmp_path):
    """run_genome pools extra-alpha models into the Spearman ranking, same
    as run_pipeline (quality mode on the mesh path)."""
    import os

    from chromosome3d.config import AnnealConfig, PipelineConfig, RestraintConfig, fast_anneal
    from chromosome3d.parallel.genome import GenomeJob, run_genome

    src = "/root/reference/input/chr22_1mb_matrix.txt"
    if not os.path.exists(src):
        pytest.skip("reference not available")
    cfg = PipelineConfig(
        model_count=2,
        restraints=RestraintConfig(alpha=0.5),
        anneal=fast_anneal(AnnealConfig()),
        alpha_ensemble=(0.7,),
        length_buckets=(64,),
    )
    out = str(tmp_path / "g")
    summaries = run_genome(
        "/root/reference/input", out,
        cfg, jobs=[GenomeJob("chr22_1mb", src)],
    )
    s = summaries["chr22_1mb"]
    assert s["models"] == 4          # 2 base + 2 extra-alpha models pooled
    ranks = [
        n for n in os.listdir(os.path.join(out, "chr22_1mb")) if "_rank" in n
    ]
    assert len(ranks) == 4
