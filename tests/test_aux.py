"""Aux subsystem tests: checkpoint/resume, similarity tooling, coverage
reports, native C++ parser."""

import os

import numpy as np
import pytest

REF = "/root/reference"


def test_genome_checkpoint_roundtrip(tmp_path):
    from chromosome3d.utils.checkpoint import GenomeCheckpoint

    ck = GenomeCheckpoint(str(tmp_path))
    assert not ck.has("chr9_1mb")
    coords = np.random.RandomState(0).randn(4, 20, 3)
    energies = {"noe": np.arange(4.0), "overall": np.arange(4.0) * 2}
    ck.save("chr9_1mb", coords, energies, {"L": 20})
    assert ck.has("chr9_1mb")
    c2, e2, meta = ck.load("chr9_1mb")
    np.testing.assert_allclose(c2, coords)
    np.testing.assert_allclose(e2["noe"], energies["noe"])
    assert meta == {"L": 20}


def test_solver_state_roundtrip(tmp_path):
    import jax

    from chromosome3d.utils.checkpoint import load_solver_state, save_solver_state

    path = str(tmp_path / "state.npz")
    coords = np.random.RandomState(1).randn(8, 3)
    key = np.asarray(jax.random.PRNGKey(7))
    save_solver_state(path, coords, 123, key)
    c, step, k = load_solver_state(path)
    np.testing.assert_allclose(c, coords)
    assert step == 123
    np.testing.assert_array_equal(k, key)


def test_coverage_string(tiny_matrix):
    from chromosome3d.assess import coverage_string
    from chromosome3d.config import RestraintConfig
    from chromosome3d.restraints import build_restraints

    r = build_restraints(tiny_matrix, RestraintConfig())
    s = coverage_string(r)
    cov, _, trailer = s.partition(" [")
    assert len(cov) == 16
    assert f"{r.count} restraints" in trailer
    # beads 0..4 can only pair with beads >= 5 apart; all have some coverage here
    assert all(ch in "-0123456789*" for ch in cov)


def test_violation_coverage_string(tiny_matrix):
    import jax.numpy as jnp

    from chromosome3d.assess import violation_coverage_string
    from chromosome3d.config import PipelineConfig, RestraintConfig
    from chromosome3d.restraints import build_restraints

    r = build_restraints(tiny_matrix, RestraintConfig())
    cfg = PipelineConfig()
    rng = np.random.RandomState(0)
    s = violation_coverage_string(rng.randn(16, 3), r, cfg)
    assert len(s) == 16 and set(s) <= {"x", "-"}


def test_similarity_report(tmp_path):
    from chromosome3d.io.pdb import read_ca_pdb
    from chromosome3d.similarity import similarity_report, write_reduced_model

    hi = os.path.join(REF, "output_models", "chr13_500kb_rank10_a11.pdb")
    lo = os.path.join(REF, "output_models", "chr13_1mb_rank05_a11.pdb")
    if not os.path.exists(hi):
        pytest.skip("reference not available")
    out = str(tmp_path / "similarity.txt")
    results = similarity_report({"chr13": (hi, lo)}, out)
    rho, rmsd = results["chr13"]
    # published: 0.9666 / 1.619 (similarity.txt:33-35)
    assert rho == pytest.approx(0.9666, abs=0.005)
    assert rmsd == pytest.approx(1.619, abs=0.05)
    text = open(out).read()
    assert "Spearman correlation:" in text and "RMSD:" in text

    red = write_reduced_model(hi, str(tmp_path / "red.pdb"))
    ours = read_ca_pdb(red)
    shipped = read_ca_pdb(hi.replace(".pdb", "_reduced.pdb"))
    np.testing.assert_allclose(ours, shipped[: len(ours)], atol=0.01)


def test_reduced_pdb_published_byte_format(tmp_path):
    """write_reduced_pdb reproduces the shipped reduced layout byte-for-byte
    (chain B glued to resid, occ 0.20, b 10.00, CRLF, leading blank line)."""
    from chromosome3d.io.pdb import read_ca_pdb, write_reduced_pdb

    shipped = os.path.join(
        REF, "output_models", "chr12_500kb_rank02_a11_reduced.pdb"
    )
    if not os.path.exists(shipped):
        pytest.skip("reference not available")
    coords = read_ca_pdb(shipped)
    out = tmp_path / "roundtrip.pdb"
    write_reduced_pdb(out, coords)
    assert out.read_bytes() == open(shipped, "rb").read()


def _require_native():
    from chromosome3d import native

    if not native.available():
        # build on demand (the .so is deliberately not committed)
        import subprocess

        subprocess.run(
            ["make", "-C", os.path.dirname(native.__file__)],
            capture_output=True,
        )
        native._TRIED = False  # re-probe after the build
        if not native.available():
            pytest.skip("native lib not built and toolchain unavailable")
    return native


def test_native_parser_matches_python(tmp_path):
    native = _require_native()
    from chromosome3d.io.matrix import load_if_matrix

    path = os.path.join(REF, "input", "chr20_500kb_matrix.txt")
    if not os.path.exists(path):
        pytest.skip("reference not available")
    m_native = native.parse_matrix(path)
    # force the pure-python path by writing a copy the native lib also reads
    rows = ["  ".join(f"{v:.6f}" for v in row) for row in m_native]
    p2 = tmp_path / "copy.txt"
    p2.write_text("\r\n".join(rows) + "\r\n")
    m_py = load_if_matrix(str(p2))
    np.testing.assert_allclose(m_native, m_py, atol=1e-6)
    assert m_native.shape == (120, 120)


def test_native_and_python_reject_the_same_malformed_files(tmp_path):
    """Cross-path consistency: a ragged file whose token count happens to be
    a perfect square (or a file with junk tokens) must fail identically with
    or without the .so — the native parser declines, and the Python loader
    raises (ADVICE r1: the old native path silently accepted both)."""
    native = _require_native()
    from chromosome3d.io.matrix import load_if_matrix

    # 4 tokens = 2x2-square count, but rows of width 3 and 1 -> ragged
    ragged = tmp_path / "ragged.txt"
    ragged.write_text("1.0 2.0 3.0\n4.0\n")
    assert native.parse_matrix(str(ragged)) is None
    with pytest.raises(ValueError, match="ragged"):
        load_if_matrix(str(ragged))

    # junk token glued to a number
    junk = tmp_path / "junk.txt"
    junk.write_text("1.0 2.0x\n3.0 4.0\n")
    assert native.parse_matrix(str(junk)) is None
    with pytest.raises(ValueError):
        load_if_matrix(str(junk))

    # square token count arranged non-square (4 tokens in 1 row)
    nonsq = tmp_path / "nonsq.txt"
    nonsq.write_text("1.0 2.0 3.0 4.0\n")
    assert native.parse_matrix(str(nonsq)) is None
    with pytest.raises(ValueError):
        load_if_matrix(str(nonsq))

    # well-formed CRLF file parses identically on both paths
    ok = tmp_path / "ok.txt"
    ok.write_text("  1.0 2.0 \r\n 3.0 4.0 \r\n")
    got = native.parse_matrix(str(ok))
    np.testing.assert_allclose(got, [[1.0, 2.0], [3.0, 4.0]])
    np.testing.assert_allclose(load_if_matrix(str(ok)), got)


def test_profile_trace_noop():
    from chromosome3d.utils.logging import profile_trace

    with profile_trace(None):
        pass


def test_render_model(tmp_path):
    from chromosome3d.render import render_model

    rng = np.random.RandomState(0)
    # a smooth helix so the plot exercises the position colormap
    t = np.linspace(0, 6 * np.pi, 60)
    coords = np.stack([np.cos(t) * 10, np.sin(t) * 10, t], axis=1)
    png = render_model(coords, str(tmp_path / "m.png"), title="helix")
    assert os.path.getsize(png) > 5000


def test_solve_coinit_cross_resolution(tmp_path):
    """solve_coinit: lo-res solve seeded from a reduced hi-res model keeps
    finite coords, true length, and a sane consistency score."""
    import jax

    from chromosome3d.config import AnnealConfig, PipelineConfig, RestraintConfig, fast_anneal
    from chromosome3d.io.matrix import load_if_matrix
    from chromosome3d.metrics import cross_resolution_similarity
    from chromosome3d.ops.energy import dense_restraints_from_numpy
    from chromosome3d.restraints import build_restraints
    from chromosome3d.similarity import solve_coinit
    from chromosome3d.solver.anneal import solve_ensemble

    hi_path = os.path.join(REF, "input", "chr21_500kb_matrix.txt")
    lo_path = os.path.join(REF, "input", "chr21_1mb_matrix.txt")
    if not os.path.exists(hi_path):
        pytest.skip("reference not available")
    cfg = PipelineConfig(
        model_count=2,
        restraints=RestraintConfig(alpha=0.5),
        anneal=fast_anneal(AnnealConfig()),
        length_buckets=(80,),
    )
    hi_m = load_if_matrix(hi_path)
    dense = dense_restraints_from_numpy(build_restraints(hi_m, cfg.restraints))
    hi = np.asarray(
        solve_ensemble(dense, cfg.anneal, jax.random.PRNGKey(0), 2).coords
    )
    lo_m = load_if_matrix(lo_path)
    coords, order, scores = solve_coinit(lo_m, hi[0], cfg)
    assert coords.shape == (2, lo_m.shape[0], 3)
    assert np.isfinite(coords).all()
    rho, rmsd = cross_resolution_similarity(hi[0], coords[order[0]])
    assert -1.0 <= rho <= 1.0 and rmsd > 0


def test_read_similarity_report_published():
    from chromosome3d.similarity import read_similarity_report

    path = os.path.join(REF, "output_models", "similarity.txt")
    if not os.path.exists(path):
        pytest.skip("reference not available")
    rep = read_similarity_report(path)
    assert rep["chr13_500kb_rank10_a11"][0] == pytest.approx(0.9666, abs=1e-3)
    assert rep["chr21_500kb_rank04_a11"][1] == pytest.approx(4.817, abs=1e-2)
