"""Unit tests for L3 restraint generation vs hand-computed reference semantics
(chromosome3D.pl:110-162 IF2dist_new, :181-206 dist2rr, :340-362 carr2tbl)."""

import numpy as np
import pytest

from chromosome3d.config import RestraintConfig
from chromosome3d.restraints import (
    build_restraints,
    dist_to_restraints,
    if_to_dist,
    read_contact_tbl,
    write_contact_tbl,
    write_rr,
)


def perl_if2dist(matrix, k, alpha):
    """Literal transcription of the reference's loop semantics for testing."""
    L = len(matrix)
    out = np.empty((L, L))
    x = np.empty((L, L))
    total = 0.0
    for i in range(L):
        for j in range(L):
            x[i, j] = matrix[i][j] ** alpha
            total += x[i, j]
    mean = total / (L * L)
    for i in range(L):
        for j in range(L):
            v = x[i, j] / mean
            out[i, j] = -1.0 if v == 0 else k / v
    return out


def test_if2dist_matches_reference_semantics(tiny_matrix):
    cfg = RestraintConfig(kscaling=11.0, alpha=0.5)
    got = if_to_dist(tiny_matrix, cfg)
    want = perl_if2dist(tiny_matrix, 11.0, 0.5)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    # zeros map to the -1 sentinel
    assert got[0, 9] == -1.0 and got[12, 2] == -1.0


def test_if2dist_hand_value():
    # 2x2 matrix, alpha=1: x = m, mean = 2.5, d = K*2.5/m
    m = np.array([[1.0, 2.0], [3.0, 4.0]])
    cfg = RestraintConfig(kscaling=10.0, alpha=1.0)
    d = if_to_dist(m, cfg)
    np.testing.assert_allclose(d, 10.0 * 2.5 / m)


def test_dist_to_restraints_masking(tiny_matrix):
    cfg = RestraintConfig(separation=5)
    r = build_restraints(tiny_matrix, cfg)
    L = r.length
    ii, jj = np.nonzero(r.mask)
    assert (np.abs(ii - jj) >= 5).all()
    # zero-IF pairs excluded
    assert not r.mask[0, 9] and not r.mask[9, 0]
    # symmetric
    assert (r.mask == r.mask.T).all()
    np.testing.assert_allclose(r.target, r.target.T)
    # all restraints exact (neg/pos dev 0) for this pipeline
    assert (r.negdev[r.mask] == 0).all() and (r.posdev[r.mask] == 0).all()


def test_restraint_count_matches_manual(tiny_matrix):
    cfg = RestraintConfig(separation=5)
    d = if_to_dist(tiny_matrix, cfg)
    L = d.shape[0]
    manual = sum(
        1
        for i in range(L)
        for j in range(i + 1, L)
        if abs(j - i) >= 5 and d[i, j] > 0
    )
    r = dist_to_restraints(d, cfg)
    assert r.count == manual


def test_rr_and_tbl_artifacts(tmp_path, tiny_matrix):
    cfg = RestraintConfig()
    d = if_to_dist(tiny_matrix, cfg)
    rr = tmp_path / "id.rr"
    tbl = tmp_path / "contact.tbl"
    n_rr = write_rr(rr, d, cfg)
    n_tbl = write_contact_tbl(tbl, rr, cfg)
    assert n_rr == n_tbl == dist_to_restraints(d, cfg).count

    lines = rr.read_text().splitlines()
    # string-key sort order (ref :203): "10 16" < "2 7" lexicographically
    assert lines == sorted(lines, key=lambda l: " ".join(l.split()[:2]))
    for line in lines:
        f = line.split()
        assert len(f) == 5 and f[2] == f[3] and f[4] == "1.0"
        i, j = int(f[0]), int(f[1])
        assert j > i >= 1 and j - i >= cfg.separation

    tbl_lines = tbl.read_text().splitlines()
    assert all(l.startswith("assign45 (resid") for l in tbl_lines)
    # round-trip through the tbl parser
    r2 = read_contact_tbl(tbl, tiny_matrix.shape[0])
    r1 = dist_to_restraints(d, cfg)
    assert (r1.mask == r2.mask).all()
    np.testing.assert_allclose(r1.target, r2.target, atol=0.005)


def test_carr2tbl_zero_lo_special_case(tmp_path):
    cfg = RestraintConfig()
    rr = tmp_path / "x.rr"
    rr.write_text("1 7 0 8.00 1.0\n")  # lo literally "0" -> (3.6, 0.1, hi-3.6)
    tbl = tmp_path / "x.tbl"
    write_contact_tbl(tbl, rr, cfg)
    row = tbl.read_text().strip()
    assert row.endswith("3.60 0.10 4.40")


def test_golden_chr21(chr21_1mb_matrix):
    """Restraint generation on a shipped input: spot-check invariants."""
    cfg = RestraintConfig(alpha=1.1)
    r = build_restraints(chr21_1mb_matrix, cfg)
    assert r.length == 37
    assert r.count > 300
    assert (r.target[r.mask] > 0).all()


def test_kscaling_spearman_invariance(tiny_matrix):
    """K scales all targets uniformly, so the Spearman objective (and the
    relative-weighted energy landscape up to scale) is K-invariant."""
    from chromosome3d.config import RestraintConfig

    a = if_to_dist(tiny_matrix, RestraintConfig(kscaling=11.0))
    b = if_to_dist(tiny_matrix, RestraintConfig(kscaling=44.0))
    mask = a > 0
    np.testing.assert_allclose(b[mask] / a[mask], 4.0, rtol=1e-9)
