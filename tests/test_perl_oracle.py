"""Byte-diff oracle: our text artifacts vs the reference's own Perl subs.

tests/perl_oracle.pl extracts IF2dist_new/dist2rr/carr2tbl from
/root/reference/chromosome3D.pl (they are CNS-independent,
chromosome3D.pl:110-206, 340-362) and runs them directly; these tests then
require BYTE equality of the .dist/.rr/.tbl artifacts — closing the gap a
Python transcription oracle leaves (a transcription could share a bug with
the implementation; the real Perl cannot).
"""

import os
import shutil
import subprocess

import numpy as np
import pytest

from chromosome3d.config import RestraintConfig
from chromosome3d.io.matrix import load_if_matrix, write_dist_matrix
from chromosome3d.restraints import (
    dist_to_restraints,
    if_to_dist,
    write_contact_tbl,
    write_rr,
)

REF_SCRIPT = "/root/reference/chromosome3D.pl"
REF_INPUT = "/root/reference/input"
HARNESS = os.path.join(os.path.dirname(__file__), "perl_oracle.pl")

pytestmark = pytest.mark.skipif(
    shutil.which("perl") is None or not os.path.isfile(REF_SCRIPT),
    reason="perl or the reference checkout is unavailable",
)


def run_oracle(tmp_path, matrix_path, k, alpha, sep):
    out = subprocess.run(
        ["perl", HARNESS, REF_SCRIPT, matrix_path, str(tmp_path),
         str(k), str(alpha), str(sep)],
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, f"oracle failed: {out.stderr}"
    return (
        (tmp_path / "oracle.dist").read_bytes(),
        (tmp_path / "oracle.rr").read_bytes(),
        (tmp_path / "oracle.tbl").read_bytes(),
    )


def ours(tmp_path, matrix_path, k, alpha, sep):
    cfg = RestraintConfig(kscaling=k, alpha=alpha, separation=sep)
    d = if_to_dist(load_if_matrix(matrix_path), cfg)
    write_dist_matrix(tmp_path / "ours.dist", d)
    write_rr(tmp_path / "ours.rr", d, cfg)
    write_contact_tbl(tmp_path / "ours.tbl", tmp_path / "ours.rr", cfg)
    return (
        (tmp_path / "ours.dist").read_bytes(),
        (tmp_path / "ours.rr").read_bytes(),
        (tmp_path / "ours.tbl").read_bytes(),
        dist_to_restraints(d, cfg),
    )


@pytest.mark.parametrize(
    "name,k,alpha",
    [
        ("chr22_1mb_matrix.txt", 11.0, 0.5),   # defaults (chromosome3D.pl:18-19)
        ("chr21_1mb_matrix.txt", 11.0, 1.1),   # the published models' alpha tag
        ("chr19_1mb_matrix.txt", 7.0, 0.7),    # off-default K and alpha
    ],
)
def test_artifacts_byte_equal_vs_perl(tmp_path, name, k, alpha):
    matrix_path = os.path.join(REF_INPUT, name)
    ref_dist, ref_rr, ref_tbl = run_oracle(tmp_path, matrix_path, k, alpha, 5)
    my_dist, my_rr, my_tbl, restraints = ours(tmp_path, matrix_path, k, alpha, 5)
    assert my_dist == ref_dist
    assert my_rr == ref_rr
    assert my_tbl == ref_tbl
    # the dense solver tensors carry the same restraint set as the tbl
    assert restraints.count == ref_tbl.count(b"assign45")
    tbl_targets = sorted(
        float(line.split()[-3]) for line in ref_tbl.decode().splitlines()
    )
    ii, jj = np.nonzero(np.triu(restraints.mask, k=1))
    dense_targets = sorted(float(v) for v in restraints.target[ii, jj])
    np.testing.assert_allclose(dense_targets, tbl_targets, atol=0.005)


def test_small_distance_rows_dropped_like_perl(tmp_path):
    """Distances in (0, 0.05) print as '0.0' in the .dist file and are then
    dropped by dist2rr's `d <= 0` skip — our mask must agree."""
    rng = np.random.RandomState(0)
    L = 24
    m = rng.gamma(2.0, 3.0, size=(L, L)) ** 4  # huge IF -> tiny distances
    m = (m + m.T) / 2
    path = tmp_path / "tiny_matrix.txt"
    with open(path, "w") as f:
        for row in m:
            f.write(" ".join(f"{v:.6f}" for v in row) + "\n")
    cfg = RestraintConfig(kscaling=0.02, alpha=1.0, separation=2)
    d = if_to_dist(load_if_matrix(path), cfg)
    assert ((d > 0) & (d < 0.05)).any(), "fixture must exercise the 0.0 round"
    ref_dist, ref_rr, ref_tbl = run_oracle(tmp_path, str(path), 0.02, 1.0, 2)
    my_dist, my_rr, my_tbl, restraints = ours(tmp_path, str(path), 0.02, 1.0, 2)
    assert my_dist == ref_dist
    assert my_rr == ref_rr
    assert my_tbl == ref_tbl
    assert restraints.count == len(ref_rr.splitlines())
