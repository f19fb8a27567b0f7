"""Real-world Hi-C input formats (io/hic.py): HiC-Pro triplets, cooler
(HDF5), and juicer .hic v8 — each round-tripped against a file built here
from the public format specs."""

import os
import struct
import zlib

import numpy as np
import pytest

from chromosome3d.io.hic import (
    load_any,
    load_cooler,
    load_hic,
    load_sparse_triplet,
)


def dense_case(L=12, seed=0):
    rng = np.random.RandomState(seed)
    m = rng.poisson(8.0, size=(L, L)).astype(np.float64)
    m = np.triu(m) + np.triu(m, 1).T
    return m


# ---------------------------------------------------------------------------
# HiC-Pro triplets
# ---------------------------------------------------------------------------

def test_sparse_triplet_roundtrip(tmp_path):
    m = dense_case()
    L = m.shape[0]
    rows = [
        f"{i + 1}\t{j + 1}\t{m[i, j]:g}"
        for i in range(L)
        for j in range(i, L)
        if m[i, j] != 0
    ]
    p = tmp_path / "chr_test.matrix"
    p.write_text("\n".join(rows) + "\n")
    got = load_sparse_triplet(p)
    np.testing.assert_allclose(got, m)
    # via the dispatcher
    np.testing.assert_allclose(load_any(p), m)


def test_sparse_triplet_bed_chromosome_slice(tmp_path):
    m = dense_case(8, seed=1)
    # bins 1..4 = chrA, 5..12 = chrB; we embed m as chrB's intra block
    rows = []
    for i in range(8):
        for j in range(i, 8):
            if m[i, j]:
                rows.append(f"{i + 5} {j + 5} {m[i, j]:g}")
    rows.append("1 2 99")  # chrA noise that must be excluded
    mat = tmp_path / "all.matrix"
    mat.write_text("\n".join(rows) + "\n")
    bed = tmp_path / "all.bed"
    bed.write_text(
        "\n".join(
            [f"chrA\t{i * 10}\t{(i + 1) * 10}\t{i + 1}" for i in range(4)]
            + [f"chrB\t{i * 10}\t{(i + 1) * 10}\t{i + 5}" for i in range(8)]
        )
        + "\n"
    )
    got = load_sparse_triplet(mat, bed, "chrB")
    np.testing.assert_allclose(got, m)


# ---------------------------------------------------------------------------
# cooler (HDF5 via h5py)
# ---------------------------------------------------------------------------

def make_cool(path, m, chrom="chr21", binsize=10, group=None):
    h5py = pytest.importorskip("h5py")
    L = m.shape[0]
    ii, jj = np.nonzero(np.triu(m))
    with h5py.File(path, "a") as f:
        g = f.create_group(group) if group else f
        g.create_dataset("chroms/name", data=[chrom.encode()])
        g.create_dataset("chroms/length", data=[L * binsize])
        g.create_dataset("bins/chrom", data=np.zeros(L, np.int32))
        g.create_dataset("bins/start", data=np.arange(L) * binsize)
        g.create_dataset("bins/end", data=(np.arange(L) + 1) * binsize)
        g.create_dataset("pixels/bin1_id", data=ii.astype(np.int64))
        g.create_dataset("pixels/bin2_id", data=jj.astype(np.int64))
        g.create_dataset("pixels/count", data=m[ii, jj])


def test_cooler_roundtrip(tmp_path):
    m = dense_case()
    p = str(tmp_path / "x.cool")
    make_cool(p, m)
    np.testing.assert_allclose(load_cooler(p), m)
    np.testing.assert_allclose(load_any(p, chrom="chr21"), m)


def test_mcool_resolution_selection(tmp_path):
    m = dense_case(10, seed=2)
    p = str(tmp_path / "x.mcool")
    make_cool(p, m, group="resolutions/5000")
    with pytest.raises(ValueError, match="resolution"):
        load_cooler(p)
    np.testing.assert_allclose(load_cooler(p, resolution=5000), m)


# ---------------------------------------------------------------------------
# juicer .hic v8 (file built per github.com/aidenlab/hic-format)
# ---------------------------------------------------------------------------

def make_hic_v8(path, m, chrom="chr21", resolution=100, use_short=True,
                block_type=1):
    """Write a minimal spec-conformant v8 .hic: one chromosome, one BP
    resolution, one zlib block holding the upper-triangle records."""
    L = m.shape[0]

    def s(x):
        return x.encode() + b"\0"

    # ---- block payload ----
    ii, jj = np.nonzero(np.triu(m))
    blk = struct.pack("<i", len(ii))                 # nRecords
    blk += struct.pack("<ii", 0, 0)                  # binColumn/RowOffset
    blk += struct.pack("<b", 1 if use_short else 0)  # useShort values
    blk += struct.pack("<b", block_type)
    if block_type == 1:
        rows = {}
        for i, j in zip(ii, jj):                     # y=row=i, x=col=j
            rows.setdefault(int(i), []).append(int(j))
        blk += struct.pack("<h", len(rows))
        for y in sorted(rows):
            blk += struct.pack("<hh", y, len(rows[y]))
            for x in sorted(rows[y]):
                blk += struct.pack("<h", x)
                blk += (
                    struct.pack("<h", int(m[y, x]))
                    if use_short
                    else struct.pack("<f", m[y, x])
                )
    else:                                            # dense block
        w = L
        blk += struct.pack("<ih", L * L, w)
        for k in range(L * L):
            row, col = divmod(k, w)
            v = m[row, col] if col >= row else (-32768 if use_short else 0.0)
            blk += (
                struct.pack("<h", int(v)) if use_short else struct.pack("<f", v)
            )
    zblk = zlib.compress(blk)

    # ---- header ----
    head = s("HIC") + struct.pack("<i", 8)
    head += struct.pack("<q", 0)                     # master pos (patched)
    master_pos_at = len(head) - 8
    head += s("test_genome")
    head += struct.pack("<i", 0)                     # nAttributes
    head += struct.pack("<i", 1) + s(chrom) + struct.pack("<i", L * resolution)
    head += struct.pack("<i", 1) + struct.pack("<i", resolution)
    head += struct.pack("<i", 0)                     # nFragResolutions

    # ---- matrix record ----
    matrix_pos = len(head)
    mat = struct.pack("<ii", 0, 0)                   # chr1Idx, chr2Idx
    mat += struct.pack("<i", 1)                      # nResolutions
    mat += s("BP") + struct.pack("<i", 0)            # unit, zoom index
    mat += struct.pack("<fiff", float(m.sum()), int(len(ii)), 0.0, 0.0)
    mat += struct.pack("<iii", resolution, L, 1)     # binSize, blockBinCount, blockColumnCount
    mat += struct.pack("<i", 1)                      # blockCount
    block_pos = None                                 # patched below
    mat += struct.pack("<i", 0)                      # block number
    block_entry_at = matrix_pos + len(mat)
    mat += struct.pack("<qi", 0, len(zblk))          # position (patched), size

    body = head + mat
    block_pos = len(body)
    body += zblk

    # ---- footer: master index ----
    master_pos = len(body)
    foot = struct.pack("<i", 0)                      # nBytesV5 (unused here)
    foot += struct.pack("<i", 1)                     # nEntries
    foot += s("0_0") + struct.pack("<qi", matrix_pos, len(mat))
    body += foot

    buf = bytearray(body)
    struct.pack_into("<q", buf, master_pos_at, master_pos)
    struct.pack_into("<q", buf, block_entry_at, block_pos)
    with open(path, "wb") as f:
        f.write(bytes(buf))


@pytest.mark.parametrize("use_short,block_type", [(True, 1), (False, 1), (True, 2)])
def test_hic_v8_roundtrip(tmp_path, use_short, block_type):
    m = dense_case(9, seed=3)
    if not use_short:
        m = m + 0.5  # exercise float records
    p = str(tmp_path / "x.hic")
    make_hic_v8(p, m, use_short=use_short, block_type=block_type)
    got = load_hic(p, "chr21", 100)
    np.testing.assert_allclose(got, m)


def test_hic_error_paths(tmp_path):
    m = dense_case(6)
    p = str(tmp_path / "x.hic")
    make_hic_v8(p, m)
    with pytest.raises(ValueError, match="chromosome"):
        load_hic(p, "chrX", 100)
    with pytest.raises(ValueError, match="resolution"):
        load_hic(p, "chr21", 999)
    bad = tmp_path / "bad.hic"
    bad.write_bytes(b"NOT\0" + b"\0" * 32)
    with pytest.raises(ValueError, match="magic"):
        load_hic(str(bad), "chr21", 100)


def test_formats_feed_the_pipeline(tmp_path):
    """A cooler matrix drives restraint generation like the text format."""
    from chromosome3d.config import RestraintConfig
    from chromosome3d.restraints import build_restraints

    m = dense_case(16, seed=4) + 1.0     # strictly positive IF
    p = str(tmp_path / "y.cool")
    make_cool(p, m)
    loaded = load_any(p, chrom="chr21")
    r = build_restraints(loaded, RestraintConfig(separation=2))
    assert r.count > 0
    assert (r.target[r.mask] > 0).all()


def test_run_pipeline_from_cooler(tmp_path):
    """End-to-end: a .cool input drives the full pipeline and materializes
    the {ident}.txt artifact like a native text run."""
    import os

    from chromosome3d.config import AnnealConfig, PipelineConfig, RestraintConfig, fast_anneal
    from chromosome3d.pipeline import run_pipeline

    m = dense_case(24, seed=5) + 1.0
    src = str(tmp_path / "chrT.cool")
    make_cool(src, m, chrom="chrT")
    out = str(tmp_path / "out")
    cfg = PipelineConfig(
        model_count=2,
        restraints=RestraintConfig(separation=2),
        anneal=fast_anneal(AnnealConfig(), 0.1),
        length_buckets=(32,),
    )
    summary = run_pipeline(src, out, cfg, chrom="chrT")
    assert summary["L"] == 24
    assert os.path.exists(os.path.join(out, "chrT.txt"))
    assert os.path.exists(os.path.join(out, "chrT_model1.pdb"))


def test_ice_balance():
    from chromosome3d.io.hic import ice_balance

    rng = np.random.RandomState(7)
    L = 40
    # true uniform contact matrix distorted by multiplicative per-bin biases
    bias = np.exp(rng.normal(0, 0.5, L))
    base = rng.poisson(50.0, size=(L, L)).astype(np.float64)
    base = (base + base.T) / 2
    m = base * bias[:, None] * bias[None, :]
    # one dead bin (no coverage) must come back zero, not NaN
    m[3, :] = m[:, 3] = 0.0
    w = ice_balance(m)
    assert np.isfinite(w).all()
    np.testing.assert_allclose(w, w.T, rtol=1e-10)
    assert (w[3, :] == 0).all() and (w[:, 3] == 0).all()
    good = w.sum(1) > 0
    sums = w[good].sum(axis=1)
    # equal visibility: row sums within 1% of each other
    assert sums.std() / sums.mean() < 0.01
    # intensity preserved so if_to_dist's K scaling is comparable
    assert w.sum() == pytest.approx(m[good][:, good].sum(), rel=1e-6)


def test_run_pipeline_ice(tmp_path):
    import os

    from chromosome3d.config import AnnealConfig, PipelineConfig, RestraintConfig, fast_anneal
    from chromosome3d.io.matrix import load_if_matrix, write_if_matrix
    from chromosome3d.pipeline import run_pipeline

    rng = np.random.RandomState(8)
    L = 20
    bias = np.exp(rng.normal(0, 0.4, L))
    base = rng.poisson(30.0, size=(L, L)).astype(np.float64) + 1.0
    m = ((base + base.T) / 2) * bias[:, None] * bias[None, :]
    src = str(tmp_path / "raw.txt")
    write_if_matrix(src, m)
    cfg = PipelineConfig(
        model_count=2,
        restraints=RestraintConfig(separation=2),
        anneal=fast_anneal(AnnealConfig(), 0.1),
        length_buckets=(32,),
    )
    out = str(tmp_path / "out")
    summary = run_pipeline(src, out, cfg, ice=True)
    assert summary["L"] == L
    balanced = load_if_matrix(os.path.join(out, "raw.txt"))
    sums = balanced.sum(1)
    assert sums.std() / sums.mean() < 0.01


# ---------------------------------------------------------------------------
# juicer .hic v9 (+ normalization vectors)
# ---------------------------------------------------------------------------

def make_hic_v9(path, m, chrom="chr21", resolution=100, use_float=False,
                use_int_pos=False, representation=1, norms=None):
    """Write a minimal spec-conformant v9 .hic: 64-bit chromosome sizes,
    nvi header fields, the v9 block flag layout (useFloatContact/
    useIntXPos/useIntYPos/matrixRepresentation), long nBytesV5, and a
    normalization-vector index with float32 vectors."""
    L = m.shape[0]
    norms = norms or {}

    def s(x):
        return x.encode() + b"\0"

    pos_fmt = "<i" if use_int_pos else "<h"

    # ---- block payload (v9 flags) ----
    ii, jj = np.nonzero(np.triu(m))
    blk = struct.pack("<i", len(ii))
    blk += struct.pack("<ii", 0, 0)                  # binColumn/RowOffset
    blk += struct.pack("<b", 1 if use_float else 0)  # useFloatContact
    blk += struct.pack("<b", 1 if use_int_pos else 0)  # useIntXPos
    blk += struct.pack("<b", 1 if use_int_pos else 0)  # useIntYPos
    blk += struct.pack("<b", representation)
    if representation == 1:
        rows = {}
        for i, j in zip(ii, jj):
            rows.setdefault(int(i), []).append(int(j))
        blk += struct.pack(pos_fmt, len(rows))
        for y in sorted(rows):
            blk += struct.pack(pos_fmt, y)
            blk += struct.pack(pos_fmt, len(rows[y]))
            for x in sorted(rows[y]):
                blk += struct.pack(pos_fmt, x)
                blk += (
                    struct.pack("<f", m[y, x]) if use_float
                    else struct.pack("<h", int(m[y, x]))
                )
    else:                                            # dense
        blk += struct.pack("<i", L * L)
        blk += struct.pack(pos_fmt, L)
        for k in range(L * L):
            row, col = divmod(k, L)
            v = m[row, col] if col >= row else (0.0 if use_float else -32768)
            blk += (
                struct.pack("<f", v) if use_float else struct.pack("<h", int(v))
            )
    zblk = zlib.compress(blk)

    # ---- header ----
    head = s("HIC") + struct.pack("<i", 9)
    head += struct.pack("<q", 0)                     # master pos (patched)
    master_pos_at = len(head) - 8
    head += s("test_genome")
    head += struct.pack("<qq", 0, 0)                 # nvi position/length
    head += struct.pack("<i", 0)                     # nAttributes
    head += struct.pack("<i", 1) + s(chrom)
    head += struct.pack("<q", L * resolution)        # v9: long size
    head += struct.pack("<i", 1) + struct.pack("<i", resolution)
    head += struct.pack("<i", 0)                     # nFragResolutions

    # ---- matrix record ----
    matrix_pos = len(head)
    mat = struct.pack("<ii", 0, 0)
    mat += struct.pack("<i", 1)
    mat += s("BP") + struct.pack("<i", 0)
    mat += struct.pack("<fiff", float(m.sum()), int(len(ii)), 0.0, 0.0)
    mat += struct.pack("<iii", resolution, L, 1)
    mat += struct.pack("<i", 1)
    mat += struct.pack("<i", 0)                      # block number
    block_entry_at = matrix_pos + len(mat)
    mat += struct.pack("<qi", 0, len(zblk))          # position (patched), size

    body = head + mat
    block_pos = len(body)
    body += zblk

    # ---- footer ----
    master_pos = len(body)
    foot = struct.pack("<q", 0)                      # v9: long nBytesV5
    foot += struct.pack("<i", 1)
    foot += s("0_0") + struct.pack("<qi", matrix_pos, len(mat))
    foot += struct.pack("<i", 0)                     # nExpectedValueVectors
    foot += struct.pack("<i", 0)                     # nNormExpectedValueVectors
    foot += struct.pack("<i", len(norms))            # norm vector index
    norm_entry_at = {}
    for name in norms:
        foot += s(name) + struct.pack("<i", 0)       # type, chrIdx
        foot += s("BP") + struct.pack("<i", resolution)
        norm_entry_at[name] = master_pos + len(foot)
        vec_bytes = 8 + 4 * len(norms[name])
        foot += struct.pack("<qq", 0, vec_bytes)     # position (patched), nBytes
    body += foot
    norm_pos = {}
    for name, vec in norms.items():
        norm_pos[name] = len(body)
        body += struct.pack("<q", len(vec))          # v9: long nValues
        body += np.asarray(vec, "<f4").tobytes()     # v9: float32 values

    buf = bytearray(body)
    struct.pack_into("<q", buf, master_pos_at, master_pos)
    struct.pack_into("<q", buf, block_entry_at, block_pos)
    for name, at in norm_entry_at.items():
        struct.pack_into("<q", buf, at, norm_pos[name])
    with open(path, "wb") as f:
        f.write(bytes(buf))


@pytest.mark.parametrize(
    "use_float,use_int_pos,representation",
    [(False, False, 1), (True, False, 1), (False, True, 1),
     (True, True, 1), (False, False, 2), (True, True, 2)],
)
def test_hic_v9_roundtrip(tmp_path, use_float, use_int_pos, representation):
    m = dense_case(9, seed=5)
    if use_float:
        m = m + 0.25
    p = str(tmp_path / "x9.hic")
    make_hic_v9(p, m, use_float=use_float, use_int_pos=use_int_pos,
                representation=representation)
    got = load_hic(p, "chr21", 100)
    np.testing.assert_allclose(got, m, rtol=1e-6)


def test_hic_v9_norm_vector_applied(tmp_path):
    """A KR-normalized load must equal the hand-computed
    raw / (v[i] * v[j]) block, with zero/NaN bins zeroed out."""
    m = dense_case(8, seed=6).astype(np.float64)
    L = m.shape[0]
    rng = np.random.RandomState(7)
    kr = rng.uniform(0.5, 2.0, L)
    kr[3] = np.nan                                  # filtered bin
    vc = rng.uniform(0.5, 2.0, L)
    p = str(tmp_path / "n9.hic")
    make_hic_v9(p, m, norms={"KR": kr, "VC": vc})

    raw = load_hic(p, "chr21", 100)
    np.testing.assert_allclose(raw, m)

    got = load_hic(p, "chr21", 100, norm="KR")
    kr32 = kr.astype(np.float32).astype(np.float64)  # stored as f4
    want = m / kr32[:, None] / kr32[None, :]
    want[3, :] = 0.0
    want[:, 3] = 0.0
    np.testing.assert_allclose(got, want, rtol=1e-6)

    got_vc = load_hic(p, "chr21", 100, norm="VC")
    vc32 = vc.astype(np.float32).astype(np.float64)
    np.testing.assert_allclose(got_vc, m / vc32[:, None] / vc32[None, :],
                               rtol=1e-6)

    with pytest.raises(ValueError, match="normalization vector"):
        load_hic(p, "chr21", 100, norm="SCALE")


def test_hic_v8_norm_vector_applied(tmp_path):
    """v8 files carry no norm sections in our fixture: requesting one must
    fail cleanly, raw load unchanged."""
    m = dense_case(6, seed=8)
    p = str(tmp_path / "v8.hic")
    make_hic_v8(p, m)
    np.testing.assert_allclose(load_hic(p, "chr21", 100), m)


def test_cooler_balance_weights(tmp_path):
    """balance=True applies bins/weight (balanced = count * w_i * w_j);
    NaN-weight bins come back zero; missing column raises."""
    h5py = pytest.importorskip("h5py")
    m = dense_case(8, seed=9)
    p = str(tmp_path / "b.cool")
    make_cool(p, m)
    rng = np.random.RandomState(1)
    w = rng.uniform(0.5, 2.0, 8)
    w[2] = np.nan
    with h5py.File(p, "a") as f:
        f.create_dataset("bins/weight", data=w)
    got = load_cooler(p, balance=True)
    wv = np.where(np.isfinite(w), w, 0.0)
    np.testing.assert_allclose(got, m * wv[:, None] * wv[None, :])
    assert (got[2] == 0).all() and (got[:, 2] == 0).all()
    # via the dispatcher norm flag
    np.testing.assert_allclose(
        load_any(p, chrom="chr21", norm="weight"), got
    )
    # raw load unchanged
    np.testing.assert_allclose(load_cooler(p), m)

    p2 = str(tmp_path / "nw.cool")
    make_cool(p2, m)
    with pytest.raises(ValueError, match="bins/weight"):
        load_cooler(p2, balance=True)


def test_run_pipeline_from_hic_v9_with_norm(tmp_path):
    """End-to-end: a juicer v9 file with a KR vector drives the pipeline
    through `run` semantics (load_any -> materialized .txt -> solve)."""
    from chromosome3d.config import (
        AnnealConfig,
        PipelineConfig,
        RestraintConfig,
        fast_anneal,
    )
    from chromosome3d.pipeline import run_pipeline

    rng = np.random.RandomState(12)
    m = dense_case(20, seed=12) + 1.0
    kr = rng.uniform(0.8, 1.2, 20)
    p = str(tmp_path / "v9_matrix.hic")
    make_hic_v9(p, m, chrom="chr21", resolution=100, norms={"KR": kr})
    cfg = PipelineConfig(
        model_count=2,
        restraints=RestraintConfig(alpha=1.1, separation=2),
        anneal=fast_anneal(AnnealConfig()),
        length_buckets=(32,),
    )
    out = str(tmp_path / "out")
    summary = run_pipeline(
        p, out, cfg, chrom="chr21", resolution=100, norm="KR"
    )
    assert summary["L"] == 20
    # the materialized matrix carries the NORMALIZED values
    from chromosome3d.io.matrix import load_if_matrix

    kr32 = kr.astype(np.float32).astype(np.float64)
    want = m / kr32[:, None] / kr32[None, :]
    got = load_if_matrix(os.path.join(out, "v9_matrix.txt"))
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_hic_float_dense_nan_sentinel(tmp_path):
    """Float dense blocks use NaN as the missing-value sentinel (the juicer
    writers' convention; short blocks use -32768): NaN cells must be
    skipped, not accumulated into the matrix."""
    m = dense_case(6, seed=13) + 0.5
    p = str(tmp_path / "nan.hic")
    # v9 dense float block: the writer emits 0.0 for the lower triangle; a
    # juicer writer would emit NaN there — patch the file's block to use NaN
    make_hic_v9(p, m, use_float=True, representation=2)
    got = load_hic(p, "chr21", 100)
    np.testing.assert_allclose(got, m)

    # hand-build the NaN variant through the same writer path
    import chromosome3d.io.hic as hic

    raw = open(p, "rb").read()
    # decode, patch the one zlib block: rewrite lower-triangle 0.0 -> NaN
    # (simpler: rebuild with a writer tweak via monkeypatching struct is
    # overkill — directly exercise the parser)
    blk = struct.pack("<i", 3)                       # nRecords (unused count)
    blk += struct.pack("<ii", 0, 0)
    blk += struct.pack("<bbbb", 1, 0, 0, 2)          # float, short pos, dense
    blk += struct.pack("<i", 4) + struct.pack("<h", 2)
    for v in (1.5, float("nan"), float("nan"), 2.5):
        blk += struct.pack("<f", v)
    recs = hic._parse_block_v9(hic._Reader(blk))
    mat = np.zeros((2, 2))
    hic._add_records(mat, recs)
    assert mat[0, 0] == 1.5 and mat[1, 1] == 2.5
    assert mat[0, 1] == 0.0 and mat[1, 0] == 0.0     # NaN skipped
    assert np.isfinite(mat).all()


# ---------------------------------------------------------------------------
# FROZEN fixture assets (round-4 item: reader bugs must not hide behind
# writer symmetry). tests/assets/fixture_v{8,9}.hic + fixture.cool were
# hand-assembled ONCE from the published specs by scripts/make_hic_fixture.py
# (which imports nothing from this package) and committed; the expected
# matrices are frozen .npy files computed straight from the chosen records.
# A reader regression — or any drift in spec interpretation — now fails
# against immutable bytes.
# ---------------------------------------------------------------------------

ASSETS = os.path.join(os.path.dirname(__file__), "assets")


@pytest.mark.parametrize("version", [8, 9])
def test_frozen_hic_fixture(version):
    from chromosome3d.io.hic import load_hic

    path = os.path.join(ASSETS, f"fixture_v{version}.hic")
    exp = np.load(os.path.join(ASSETS, f"fixture_v{version}_none.npy"))
    m = load_hic(path, "chrF", 100)
    np.testing.assert_allclose(m, exp, rtol=1e-6)
    # the KR normalization vector in the frozen footer
    exp_kr = np.load(os.path.join(ASSETS, f"fixture_v{version}_kr.npy"))
    m_kr = load_hic(path, "chrF", 100, norm="KR")
    np.testing.assert_allclose(m_kr, exp_kr, rtol=1e-6)
    # selecting the blockless resolution or missing chromosome must raise
    with pytest.raises(ValueError):
        load_hic(path, "chrF", 1000)
    with pytest.raises(ValueError):
        load_hic(path, "chrZ", 100)


def test_frozen_cool_fixture():
    from chromosome3d.io.hic import load_cooler

    path = os.path.join(ASSETS, "fixture.cool")
    exp = np.load(os.path.join(ASSETS, "fixture_cool_raw.npy"))
    m = load_cooler(path, chrom="chrA")
    np.testing.assert_allclose(m, exp, rtol=1e-6)
    # inter-chromosomal pixels excluded; chrB block independently correct
    mb = load_cooler(path, chrom="chrB")
    assert mb.shape == (3, 3)
    assert mb[0, 1] == 2 and mb[1, 2] == 6 and mb[0, 0] == 9
    # balanced load: stored weights applied, NaN-weight bin zeroed
    exp_bal = np.load(os.path.join(ASSETS, "fixture_cool_balanced.npy"))
    np.testing.assert_allclose(
        load_cooler(path, chrom="chrA", balance=True), exp_bal, rtol=1e-6
    )


def test_frozen_assets_unchanged():
    """The fixture BYTES are part of the contract: regenerating them must
    reproduce the committed blobs exactly (catches accidental edits to
    scripts/make_hic_fixture.py drifting the assets)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_hic_fixture",
        os.path.join(os.path.dirname(__file__), "..", "scripts",
                     "make_hic_fixture.py"),
    )
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    for version in (8, 9):
        with open(os.path.join(ASSETS, f"fixture_v{version}.hic"), "rb") as f:
            assert gen.make_hic(version) == f.read()
