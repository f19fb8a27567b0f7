"""At-scale assessment equivalence: beyond FULL_REPORT_MAX the host
assessment switches to row-chunked traversals (no (L, L, 3) diff tensors, no
~L^2/2-element index arrays — multi-GB allocations on the production host at
L >= 16384). These tests pin the chunked routes to the gathered/dense
reference implementations by lowering the thresholds on small inputs."""

import numpy as np
import pytest

import chromosome3d.assess as assess_mod
import chromosome3d.metrics as metrics_mod
from chromosome3d.config import PipelineConfig, RestraintConfig
from chromosome3d.restraints import build_restraints


@pytest.fixture()
def case(tiny_matrix):
    r = build_restraints(tiny_matrix, RestraintConfig())
    rng = np.random.RandomState(3)
    coords = rng.randn(4, r.length, 3) * 6
    return r, coords


def test_assess_ensemble_chunked_matches(case):
    from chromosome3d.ops.energy import dense_restraints_from_numpy

    r, coords = case
    dense = dense_restraints_from_numpy(r, as_numpy=True)
    cfg = PipelineConfig()
    ref = assess_mod.assess_ensemble(coords, dense, cfg)
    orig = assess_mod.FULL_REPORT_MAX
    try:
        assess_mod.FULL_REPORT_MAX = 1
        got = assess_mod.assess_ensemble(coords, dense, cfg)
    finally:
        assess_mod.FULL_REPORT_MAX = orig
    np.testing.assert_array_equal(got["satisfied"], ref["satisfied"])
    np.testing.assert_array_equal(got["total"], ref["total"])
    np.testing.assert_allclose(got["sum_dev"], ref["sum_dev"], rtol=1e-12)


def test_violation_report_chunked_matches(case, tmp_path):
    r, coords = case
    cfg = PipelineConfig()
    full = tmp_path / "full.txt"
    s_ref, t_ref = assess_mod.write_violation_report(full, coords[0], r, cfg)
    # the violated rows of the full report, in order (flag column == 1)
    ref_lines = [
        ln for ln in full.read_text().splitlines()
        if not ln.startswith("#") and ln.lstrip().startswith("1\t")
    ]
    chunked = tmp_path / "chunked.txt"
    orig = assess_mod.FULL_REPORT_MAX
    try:
        assess_mod.FULL_REPORT_MAX = 1
        s_got, t_got = assess_mod.write_violation_report(
            chunked, coords[0], r, cfg
        )
    finally:
        assess_mod.FULL_REPORT_MAX = orig
    assert (s_got, t_got) == (s_ref, t_ref)
    body = [
        ln for ln in chunked.read_text().splitlines() if not ln.startswith("#")
    ]
    assert body == ref_lines
    header = chunked.read_text().splitlines()[2]
    assert f"{s_ref}/{t_ref} satisfied" in header


def test_violation_report_chunked_append(case, tmp_path):
    r, coords = case
    cfg = PipelineConfig()
    path = tmp_path / "v.txt"
    orig = assess_mod.FULL_REPORT_MAX
    try:
        assess_mod.FULL_REPORT_MAX = 1
        assess_mod.write_violation_report(path, coords[0], r, cfg)
        assess_mod.write_violation_report(
            path, coords[1], r, cfg, pdb_name="m2", append=True
        )
    finally:
        assess_mod.FULL_REPORT_MAX = orig
    text = path.read_text()
    assert text.count("#NOE violation check") == 2


def test_spearman_subsample_close_and_gated(tiny_matrix):
    """Below the pair threshold the statistic is EXACT (reference scale);
    above it the fixed-seed subsample estimates it closely."""
    rng = np.random.RandomState(0)
    L = 200
    # structured coords + IF consistent with them: strong true correlation
    t = np.linspace(0, 12 * np.pi, L)
    coords = np.stack([np.cos(t) * 20, np.sin(t) * 20, t], 1)
    coords += rng.randn(L, 3) * 0.5
    d = np.sqrt(((coords[:, None] - coords[None, :]) ** 2).sum(-1) + 1e-9)
    ifm = (50.0 / d) ** 2
    np.fill_diagonal(ifm, 5000.0)
    exact = metrics_mod.spearman_if_model(ifm, coords)
    orig = metrics_mod.SPEARMAN_MAX_PAIRS
    try:
        metrics_mod.SPEARMAN_MAX_PAIRS = 5000
        est = metrics_mod.spearman_if_model(ifm, coords)
        est2 = metrics_mod.spearman_if_model(ifm, coords)
    finally:
        metrics_mod.SPEARMAN_MAX_PAIRS = orig
    assert est == est2                 # deterministic (fixed seed)
    assert abs(est - exact) < 0.02
    # reference scale stays exact: L=16 is far below the threshold
    small = metrics_mod.spearman_if_model(
        tiny_matrix, np.random.RandomState(1).randn(16, 3)
    )
    assert -1.0 <= small <= 1.0


def test_clash_count_chunked_matches():
    rng = np.random.RandomState(2)
    coords = rng.randn(300, 3) * 4
    ref = metrics_mod.clash_count(coords, 3.0)
    orig = metrics_mod._CLASH_CHUNK_MIN_L
    try:
        metrics_mod._CLASH_CHUNK_MIN_L = 10
        got = metrics_mod.clash_count(coords, 3.0)
    finally:
        metrics_mod._CLASH_CHUNK_MIN_L = orig
    assert got == ref
