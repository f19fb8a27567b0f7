"""Solving from restraint files (.rr / .tbl) without an IF matrix."""

import os

import numpy as np
import pytest

from chromosome3d.config import AnnealConfig, PipelineConfig, RestraintConfig, fast_anneal
from chromosome3d.restraints import read_rr


def make_rr(tmp_path, rows):
    p = tmp_path / "test.rr"
    p.write_text("\n".join(rows) + "\n")
    return str(p)


def test_read_rr_basic(tmp_path):
    p = make_rr(tmp_path, ["1 7 5.00 5.00 1.0", "2 9 4.00 8.00 0.5"])
    r, conf = read_rr(p)
    assert r.length == 9
    assert r.count == 2
    assert r.target[0, 6] == pytest.approx(5.0)
    assert r.negdev[0, 6] == 0.0
    assert r.target[1, 8] == pytest.approx(6.0)
    assert r.negdev[1, 8] == pytest.approx(2.0)
    assert conf[1, 8] == pytest.approx(0.5)
    assert conf[8, 1] == pytest.approx(0.5)


def test_read_rr_zero_lo_special_case(tmp_path):
    p = make_rr(tmp_path, ["1 7 0 8.00 1.0"])
    r, _ = read_rr(p)
    assert r.target[0, 6] == pytest.approx(3.6)
    assert r.negdev[0, 6] == pytest.approx(0.1)
    assert r.posdev[0, 6] == pytest.approx(4.4)


def test_solve_from_rr(tmp_path):
    """Restraints describing a straight chain should reconstruct one."""
    from chromosome3d.pipeline import run_restraints_pipeline

    L = 12
    rows = []
    for i in range(1, L + 1):
        for j in range(i + 1, L + 1):
            d = 4.0 * (j - i)
            rows.append(f"{i} {j} {d:.2f} {d:.2f} 1.0")
    p = make_rr(tmp_path, rows)
    cfg = PipelineConfig(model_count=2, anneal=fast_anneal(AnnealConfig()))
    out = str(tmp_path / "out")
    summary = run_restraints_pipeline(p, out, cfg)
    assert summary["L"] == L
    assert summary["restraints"] == L * (L - 1) // 2
    from chromosome3d.io.pdb import read_ca_pdb

    coords = read_ca_pdb(os.path.join(out, "test_model1.pdb"))
    d = np.linalg.norm(coords[:, None] - coords[None, :], axis=-1)
    want = 4.0 * np.abs(np.subtract.outer(np.arange(L), np.arange(L)))
    # straight-line restraints are near-satisfiable (the chain-bond term's
    # 3.8 A preference pulls slightly against the 4.0 A spacing)
    assert np.abs(d - want).max() < 2.0
    assert np.abs(d - want).mean() < 0.5
    assert os.path.exists(os.path.join(out, "test_violation.txt"))


def test_solve_from_tbl(tmp_path):
    from chromosome3d.pipeline import run_restraints_pipeline
    from chromosome3d.restraints import write_contact_tbl

    rr = make_rr(
        tmp_path, [f"1 {j} {3.0*(j-1):.2f} {3.0*(j-1):.2f} 1.0" for j in range(7, 12)]
    )
    tbl = str(tmp_path / "c.tbl")
    write_contact_tbl(tbl, rr, RestraintConfig())
    cfg = PipelineConfig(model_count=2, anneal=fast_anneal(AnnealConfig()))
    summary = run_restraints_pipeline(tbl, str(tmp_path / "out"), cfg)
    assert summary["L"] == 11
    assert summary["restraints"] == 5
