"""CLI plumbing tests: argument wiring of the subcommands over tiny inputs
(the heavy paths are covered by their library tests; these assert the
flags reach the right functions and artifacts land where the user asked)."""

import json
import os

import numpy as np
import pytest

from chromosome3d.cli import main
from chromosome3d.io.matrix import write_if_matrix


@pytest.fixture()
def tiny_input(tmp_path):
    rng = np.random.RandomState(0)
    L = 20
    base = rng.gamma(2.0, 50.0, size=(L, L))
    m = (base + base.T) / 2 + 1.0
    np.fill_diagonal(m, 5000.0)
    p = str(tmp_path / "chrX_test_matrix.txt")
    write_if_matrix(p, m)
    return p


def test_cli_run_and_spearman(tiny_input, tmp_path, capsys):
    out = str(tmp_path / "out")
    assert main(["run", "-i", tiny_input, "-o", out, "-m", "2", "--fast",
                 "-a", "1.1"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["L"] == 20
    assert os.path.exists(os.path.join(out, "chrX_test_matrix_model1.pdb"))

    assert main(["spearman", tiny_input, out]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("SRCC")
    scores = [float(l.split()[0]) for l in lines[1:]]
    assert scores == sorted(scores, reverse=True)


def test_cli_coinit(tiny_input, tmp_path, capsys):
    # hi-res model = 2x the lo-res length, seeded from a quick run
    rng = np.random.RandomState(1)
    L = 40
    base = rng.gamma(2.0, 50.0, size=(L, L))
    m = (base + base.T) / 2 + 1.0
    np.fill_diagonal(m, 5000.0)
    hi_matrix = str(tmp_path / "chrX_hi_matrix.txt")
    write_if_matrix(hi_matrix, m)
    hi_out = str(tmp_path / "hi")
    assert main(["run", "-i", hi_matrix, "-o", hi_out, "-m", "2", "--fast"]) == 0
    capsys.readouterr()
    hi_pdb = os.path.join(hi_out, "chrX_hi_matrix_model1.pdb")

    lo_out = str(tmp_path / "lo")
    assert main(["coinit", "-i", tiny_input, "-p", hi_pdb, "-o", lo_out,
                 "-m", "2", "--fast"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert -1.0 <= res["cross_res_spearman"] <= 1.0
    assert res["models"] == 2
    ranked = [n for n in os.listdir(lo_out) if "_rank01_" in n]
    assert len(ranked) == 1


def test_cli_no_command_prints_help(capsys):
    assert main([]) == 2
    assert "chromosome3d" in capsys.readouterr().out
