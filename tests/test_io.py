"""Matrix and PDB I/O tests, including round-trips against shipped reference
artifacts (input/*.txt, output_models/*.pdb)."""

import os

import numpy as np
import pytest

from chromosome3d.io.matrix import load_if_matrix, matrix_length, write_dist_matrix
from chromosome3d.io.pdb import (
    read_ca_pdb,
    read_pdb_remarks,
    reduce_model,
    write_ca_pdb,
)

REF = "/root/reference"


def test_load_crlf_and_leading_space(tmp_path):
    p = tmp_path / "m.txt"
    p.write_bytes(b" 1.0 2.0 \r\n3.5 4.0 \r\n")
    assert matrix_length(p) == 2
    m = load_if_matrix(p)
    np.testing.assert_allclose(m, [[1.0, 2.0], [3.5, 4.0]])


def test_matrix_length_skips_blank_lines(tmp_path):
    """matrix_length is a pre-check used before load_if_matrix (serve's
    bound on hostile L): it must accept exactly what the loader accepts,
    including leading blank/CRLF-only lines (which the loader skips)."""
    p = tmp_path / "m.txt"
    p.write_bytes(b"\r\n \r\n1.0 2.0\r\n3.5 4.0\r\n")
    assert matrix_length(p) == 2
    m = load_if_matrix(p)
    assert m.shape == (2, 2)
    empty = tmp_path / "empty.txt"
    empty.write_bytes(b"\r\n  \r\n")
    with pytest.raises(ValueError):
        matrix_length(empty)


def test_load_shipped_matrix():
    path = os.path.join(REF, "input", "chr22_1mb_matrix.txt")
    if not os.path.exists(path):
        pytest.skip("reference not available")
    m = load_if_matrix(path)
    assert m.shape == (35, 35)
    assert matrix_length(path) == 35
    # near-symmetric with a dominant diagonal (SURVEY.md 2.3)
    assert np.abs(m - m.T).max() / m.max() < 0.2
    assert (np.diag(m) > np.median(m)).all()


def test_dist_matrix_format(tmp_path):
    d = np.array([[0.0, 1.25], [-1.0, 3.14159]])
    p = tmp_path / "x.dist"
    write_dist_matrix(p, d)
    lines = p.read_text().splitlines()
    assert lines[0] == "0.0 1.2 " or lines[0] == "0.0 1.2"
    assert lines[1].startswith("-1.0 3.1")


def test_pdb_round_trip(tmp_path):
    coords = np.random.RandomState(0).randn(12, 3) * 10
    p = tmp_path / "m.pdb"
    write_ca_pdb(p, coords, remarks={"noe": 12.5, "overall": 99.0})
    back = read_ca_pdb(p)
    np.testing.assert_allclose(back, coords, atol=5e-4)
    rem = read_pdb_remarks(p)
    assert rem["noe"] == pytest.approx(12.5)
    text = p.read_text()
    assert "CONECT    1    2" in text and text.strip().endswith("END")


def test_read_reference_model():
    path = os.path.join(REF, "output_models", "chr21_1mb_rank07_a11.pdb")
    if not os.path.exists(path):
        pytest.skip("reference not available")
    coords = read_ca_pdb(path)
    assert coords.shape == (37, 3)
    # consecutive bead spacing is protein-like (~4-5 A)
    steps = np.linalg.norm(np.diff(coords, axis=0), axis=1)
    assert 3.0 < steps.mean() < 6.0


def test_read_reduced_model():
    path = os.path.join(
        REF, "output_models", "chr21_500kb_rank04_a11_reduced.pdb"
    )
    if not os.path.exists(path):
        pytest.skip("reference not available")
    full = read_ca_pdb(
        os.path.join(REF, "output_models", "chr21_500kb_rank04_a11.pdb")
    )
    red = read_ca_pdb(path)
    assert len(red) == (len(full) + 1) // 2


def test_reduce_model_matches_reference_convention():
    path = os.path.join(REF, "output_models", "chr12_500kb_rank02_a11.pdb")
    red_path = os.path.join(
        REF, "output_models", "chr12_500kb_rank02_a11_reduced.pdb"
    )
    if not os.path.exists(path):
        pytest.skip("reference not available")
    full = read_ca_pdb(path)
    red_ref = read_ca_pdb(red_path)
    red_ours = reduce_model(full, 2)
    assert len(red_ours) == len(red_ref)
    # the shipped reduced files average consecutive bead pairs
    np.testing.assert_allclose(red_ours, red_ref, atol=0.01)


def test_load_rejects_corrupt_values(tmp_path):
    p = tmp_path / "bad.txt"
    p.write_text("1.0 nan\n2.0 3.0\n")
    with pytest.raises(ValueError, match="non-finite"):
        load_if_matrix(p)
    p2 = tmp_path / "neg.txt"
    p2.write_text("1.0 -2.0\n3.0 4.0\n")
    with pytest.raises(ValueError, match="negative"):
        load_if_matrix(p2)


def test_load_rejects_ragged_and_nonsquare(tmp_path):
    p = tmp_path / "ragged.txt"
    p.write_text("1.0 2.0\n3.0\n")
    with pytest.raises(ValueError, match="ragged"):
        load_if_matrix(p)
    p2 = tmp_path / "rect.txt"
    p2.write_text("1.0 2.0 3.0\n4.0 5.0 6.0\n")
    with pytest.raises(ValueError, match="square"):
        load_if_matrix(p2)


def test_native_pdb_writer_byte_parity(tmp_path, monkeypatch):
    """The C emitter (native.write_ca_pdb) must be byte-identical to the
    Python writer across remarks/connect variants; skipped when the .so is
    not built (the Python fallback is then the only path)."""
    from chromosome3d import native
    from chromosome3d.io import pdb as pdbio

    if not native.available():
        pytest.skip("native library not built")
    rng = np.random.RandomState(11)
    coords = rng.randn(23, 3) * 30
    for remarks in (None, {"noe": 1.5, "overall": -1234.56789}):
        for connect in (True, False):
            pn = tmp_path / "n.pdb"
            pp = tmp_path / "p.pdb"
            pdbio.write_ca_pdb(pn, coords, remarks=remarks, connect=connect)
            monkeypatch.setattr(native, "write_ca_pdb", lambda *a, **k: False)
            pdbio.write_ca_pdb(pp, coords, remarks=remarks, connect=connect)
            monkeypatch.undo()
            assert pn.read_bytes() == pp.read_bytes()
    # and the native file round-trips through the reader
    pdbio.write_ca_pdb(tmp_path / "rt.pdb", coords, remarks={"noe": 2.0})
    got = pdbio.read_ca_pdb(tmp_path / "rt.pdb")
    np.testing.assert_allclose(got, coords, atol=5e-4)


def test_native_text_writers_byte_parity(tmp_path, monkeypatch):
    """The native .dist/.rr/contact.tbl emitters must be byte-identical to
    the Python fallbacks (the perl-oracle tests separately pin both against
    the reference's own subs)."""
    from chromosome3d import native
    from chromosome3d.config import RestraintConfig
    from chromosome3d.restraints import if_to_dist, write_contact_tbl, write_rr

    if not native.available():
        pytest.skip("native library not built")
    rng = np.random.RandomState(3)
    L = 40
    base = rng.gamma(2.0, 50.0, size=(L, L))
    m = (base + base.T) / 2
    np.fill_diagonal(m, 5000.0)
    m[1, 8] = m[8, 1] = 0.0
    rc = RestraintConfig(alpha=1.1)
    dist = if_to_dist(m, rc)

    def run(prefix):
        dpath = tmp_path / f"{prefix}.dist"
        rpath = tmp_path / f"{prefix}.rr"
        tpath = tmp_path / f"{prefix}.tbl"
        write_dist_matrix(dpath, dist)
        n_rr = write_rr(rpath, dist, rc)
        n_tbl = write_contact_tbl(tpath, rpath, rc)
        return dpath.read_bytes(), rpath.read_bytes(), tpath.read_bytes(), n_rr, n_tbl

    nat = run("native")
    monkeypatch.setattr(native, "write_dist", lambda *a, **k: False)
    monkeypatch.setattr(native, "write_rr_rows", lambda *a, **k: False)
    monkeypatch.setattr(native, "rr_to_tbl", lambda *a, **k: None)
    py = run("python")
    assert nat[0] == py[0]      # .dist bytes
    assert nat[1] == py[1]      # .rr bytes
    assert nat[2] == py[2]      # .tbl bytes
    assert nat[3] == py[3] and nat[4] == py[4]

    # the lo=="0" special case goes through the native tbl path too
    rr0 = tmp_path / "zero.rr"
    rr0.write_text("1 9 0 8.0 1.0\n2 9 3.0 5.0 1.0\n")
    t_nat = tmp_path / "zero_nat.tbl"
    t_py = tmp_path / "zero_py.tbl"
    monkeypatch.undo()
    n1 = write_contact_tbl(t_nat, rr0, rc)
    monkeypatch.setattr(native, "rr_to_tbl", lambda *a, **k: None)
    n2 = write_contact_tbl(t_py, rr0, rc)
    assert n1 == n2 == 2
    assert t_nat.read_bytes() == t_py.read_bytes()
    assert "3.60 0.10" in t_nat.read_text()   # the zero-lo rewrite applied


def test_native_tbl_declines_malformed_rr(tmp_path):
    """Malformed rr rows must make the NATIVE converter decline (so the
    Python fallback raises the same loud error with or without the .so):
    silent acceptance would emit a wrong contact.tbl."""
    from chromosome3d import native
    from chromosome3d.config import RestraintConfig
    from chromosome3d.restraints import write_contact_tbl

    if not native.available():
        pytest.skip("native library not built")
    rc = RestraintConfig()
    for bad in ("1 2 3.0\n", "12x 5 3.0 4.0 1.0\n", "1 2 3.0 4x.0 1.0\n"):
        rr = tmp_path / "bad.rr"
        rr.write_text(bad)
        assert native.rr_to_tbl(rr, tmp_path / "n.tbl", 3.6, 0.1) is None
        with pytest.raises((ValueError, IndexError)):
            write_contact_tbl(tmp_path / "p.tbl", rr, rc)

    # a >63-char token overflows the native tokenizer's buffer: it must
    # DECLINE (not silently split the token into two parsed values) so the
    # Python writer — which parses arbitrary-width fields — handles the row
    rr = tmp_path / "wide.rr"
    rr.write_text("1 9 3." + "0" * 70 + " 4.0 1.0\n")
    assert native.rr_to_tbl(rr, tmp_path / "n.tbl", 3.6, 0.1) is None
    write_contact_tbl(tmp_path / "p.tbl", rr, rc)   # Python path succeeds
    assert "resid   9" in (tmp_path / "p.tbl").read_text()


def test_hy36_roundtrip_and_pdb_at_scale(tmp_path):
    """At-scale PDB emission: resSeq overflows its 4-char column at
    L >= 10000 — hybrid-36 (the PDB large-structure convention) keeps the
    fixed columns fixed. Round-5 ground-truth read-back at L=24576 caught
    the plain %4d overflow shifting every later column."""
    import numpy as np

    from chromosome3d.io.pdb import (
        hy36_decode,
        hy36_encode,
        read_ca_pdb,
        write_ca_pdb,
    )

    # known anchor points of the hybrid-36 spec
    assert hy36_encode(4, 9999) == "9999"
    assert hy36_encode(4, 10000) == "A000"
    assert hy36_encode(4, 10001) == "A001"
    assert hy36_encode(5, 99999) == "99999"
    assert hy36_encode(5, 100000) == "A0000"
    # uppercase block ends, lowercase begins
    top_upper = 10000 + 26 * 36 ** 3 - 1
    assert hy36_encode(4, top_upper) == "ZZZZ"
    assert hy36_encode(4, top_upper + 1) == "a000"
    for v in (0, 7, 9999, 10000, 24576, 56655, 56656, 250000):
        assert hy36_decode(4, hy36_encode(4, v)) == v
    for v in (99999, 100000, 123456, 2 * 10 ** 6):
        assert hy36_decode(5, hy36_encode(5, v)) == v

    # write/read round-trip past the decimal resSeq range
    L = 12000
    rs = np.random.RandomState(3)
    coords = np.round(rs.randn(L, 3) * 50, 3)
    p = str(tmp_path / "big.pdb")
    write_ca_pdb(p, coords, remarks={"noe": 1.0})
    back = read_ca_pdb(p)
    assert back.shape == (L, 3)
    assert np.allclose(back, coords, atol=5e-4)
    # every fixed column still parses on the overflow rows
    with open(p) as f:
        rows = [l for l in f if l.startswith("ATOM")]
    assert rows[9999][22:26] == "A000"      # resSeq 10000 in hybrid-36
    assert float(rows[11999][30:38]) == coords[11999, 0]

    # reference-scale bytes unchanged: decimal fields for L <= 9999
    small = str(tmp_path / "small.pdb")
    write_ca_pdb(small, coords[:50])
    with open(small) as f:
        first = [l for l in f if l.startswith("ATOM")][0]
    assert first[:26] == "ATOM      1  CA  MET     1"
