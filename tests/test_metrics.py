"""Metric tests: Spearman (vs scipy, with ties), Kabsch RMSD, and the
spearman_IF_pdb.pl protocol on shipped reference artifacts."""

import os

import numpy as np
import pytest
from scipy import stats as sps

from chromosome3d.metrics import (
    clash_count,
    cross_resolution_similarity,
    kabsch_rmsd,
    spearman,
    spearman_if_inv_d,
    spearman_if_model,
)

REF = "/root/reference"


def test_spearman_matches_scipy():
    rng = np.random.RandomState(1)
    a = rng.randn(200)
    b = 0.5 * a + rng.randn(200)
    got = float(spearman(a, b))
    want = sps.spearmanr(a, b).statistic
    assert got == pytest.approx(want, abs=1e-5)


def test_spearman_with_ties_matches_scipy():
    rng = np.random.RandomState(2)
    a = rng.randint(0, 10, 300).astype(float)  # heavy ties, like IF zeros
    b = a + rng.randint(0, 5, 300)
    got = float(spearman(a, b))
    want = sps.spearmanr(a, b).statistic
    assert got == pytest.approx(want, abs=1e-5)


def test_spearman_perfect_and_reversed():
    a = np.arange(50, dtype=float)
    assert float(spearman(a, a * 3 + 1)) == pytest.approx(1.0, abs=1e-6)
    assert float(spearman(a, -a)) == pytest.approx(-1.0, abs=1e-6)


def test_spearman_if_model_range_mask(tiny_matrix):
    rng = np.random.RandomState(3)
    coords = rng.randn(16, 3) * 5
    # manual computation with the reference's flattening (both triangles)
    L = 16
    d = np.linalg.norm(coords[:, None] - coords[None, :], axis=-1).round(3)
    vals_m, vals_d = [], []
    for i in range(L):
        for j in range(L):
            if abs(i - j) >= 3:
                vals_m.append(tiny_matrix[i, j])
                vals_d.append(d[i, j])
    want = sps.spearmanr(vals_m, vals_d).statistic
    got = spearman_if_model(tiny_matrix, coords, 3)
    assert got == pytest.approx(want, abs=1e-4)


def test_kabsch_identity_and_rotation():
    rng = np.random.RandomState(4)
    a = rng.randn(30, 3)
    assert kabsch_rmsd(a, a) == pytest.approx(0.0, abs=1e-9)
    theta = 0.7
    rot = np.array(
        [
            [np.cos(theta), -np.sin(theta), 0],
            [np.sin(theta), np.cos(theta), 0],
            [0, 0, 1],
        ]
    )
    b = a @ rot.T + 5.0
    assert kabsch_rmsd(a, b) == pytest.approx(0.0, abs=1e-9)
    # mirror is recovered only with allow_mirror
    m = a * np.array([-1.0, 1.0, 1.0])
    assert kabsch_rmsd(m, a, allow_mirror=True) == pytest.approx(0.0, abs=1e-9)
    assert kabsch_rmsd(m, a, allow_mirror=False) > 0.1


def test_kabsch_scale():
    rng = np.random.RandomState(5)
    a = rng.randn(30, 3)
    assert kabsch_rmsd(a * 2.5, a, allow_scale=True) == pytest.approx(0.0, abs=1e-9)


def test_clash_count():
    coords = np.array([[0, 0, 0], [0.5, 0, 0], [10, 0, 0]], dtype=float)
    assert clash_count(coords, 1.0) == 1
    assert clash_count(coords, 20.0) == 3


def test_reference_model_spearman_value(chr21_1mb_matrix):
    """Pin the published chr21_1mb model's score — the bar our solver must
    beat (computed from shipped artifacts, not hardcoded lore)."""
    from chromosome3d.io.pdb import read_ca_pdb

    path = os.path.join(REF, "output_models", "chr21_1mb_rank07_a11.pdb")
    if not os.path.exists(path):
        pytest.skip("reference not available")
    coords = read_ca_pdb(path)
    score = spearman_if_inv_d(chr21_1mb_matrix, coords)
    assert 0.80 < score < 0.90  # published model scores ~0.845


@pytest.mark.parametrize(
    "hi,lo,pub_rho,pub_rmsd",
    [
        ("chr13_500kb_rank10_a11", "chr13_1mb_rank05_a11", 0.9666, 1.619),
        ("chr12_500kb_rank02_a11", "chr12_1mb_rank01_a11", 0.9413, 2.642),
        ("chr21_500kb_rank04_a11", "chr21_1mb_rank07_a11", 0.9294, 4.817),
    ],
)
def test_cross_resolution_similarity_reproduces_published(hi, lo, pub_rho, pub_rmsd):
    """Our similarity implementation, applied to the shipped model pairs,
    must reproduce the published similarity.txt numbers."""
    from chromosome3d.io.pdb import read_ca_pdb

    hp = os.path.join(REF, "output_models", f"{hi}.pdb")
    lp = os.path.join(REF, "output_models", f"{lo}.pdb")
    if not os.path.exists(hp):
        pytest.skip("reference not available")
    rho, rmsd = cross_resolution_similarity(read_ca_pdb(hp), read_ca_pdb(lp))
    assert rho == pytest.approx(pub_rho, abs=0.005)
    assert rmsd == pytest.approx(pub_rmsd, abs=0.05)


def test_drmsd_scale_fit():
    from chromosome3d.metrics import drmsd

    rng = np.random.RandomState(7)
    a = rng.randn(20, 3) * 5
    # pure scaling is absorbed by the fit; disabled fit sees it
    assert drmsd(a * 3.0, a, fit_scale=True) == pytest.approx(0.0, abs=1e-9)
    assert drmsd(a * 3.0, a, fit_scale=False) > 1.0
    # mirror-invariant (distance-based)
    assert drmsd(a * np.array([-1.0, 1, 1]), a, fit_scale=False) == pytest.approx(
        0.0, abs=1e-9
    )
