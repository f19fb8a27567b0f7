"""Real-world Hi-C input formats -> the pipeline's dense IF matrix.

The reference only reads its own dense whitespace text format
(chromosome3D.pl:164-179). Production Hi-C data ships as:

  * cooler `.cool` / `.mcool`  (HDF5; read via h5py when available)
  * HiC-Pro sparse triplets    (`.matrix` + `.bed`; pure text)
  * juicer `.hic`              (custom binary; pure numpy/struct/zlib
                                reader for v8 files, BP resolutions,
                                intra-chromosomal counts, NONE norm)

Each loader returns a dense (L, L) float64 numpy array compatible with
`restraints.build_restraints` / `pipeline.run_pipeline(if_matrix=...)`.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# HiC-Pro sparse triplet (.matrix [+ .bed])
# ---------------------------------------------------------------------------

def load_sparse_triplet(
    matrix_path: str | os.PathLike,
    bed_path: Optional[str | os.PathLike] = None,
    chrom: Optional[str] = None,
) -> np.ndarray:
    """HiC-Pro output: `.matrix` rows are `bin_i bin_j count` (1-based bin
    ids, upper triangle); the companion `.bed` maps bins to chromosome
    coordinates. With bed_path+chrom, only that chromosome's intra block is
    returned; otherwise the matrix spans all bins seen."""
    tri = np.loadtxt(matrix_path, dtype=np.float64, ndmin=2)
    if tri.size == 0:
        raise ValueError(f"{matrix_path}: no records")
    ii = tri[:, 0].astype(np.int64)
    jj = tri[:, 1].astype(np.int64)
    vv = tri[:, 2]
    if bed_path is not None and chrom is not None:
        lo, hi = None, None
        with open(bed_path) as f:
            for line in f:
                c = line.split()
                if len(c) >= 4 and c[0] == chrom:
                    b = int(c[3])
                    lo = b if lo is None else min(lo, b)
                    hi = b if hi is None else max(hi, b)
        if lo is None:
            raise ValueError(f"{bed_path}: chromosome {chrom!r} not found")
        keep = (ii >= lo) & (ii <= hi) & (jj >= lo) & (jj <= hi)
        ii, jj, vv = ii[keep] - lo, jj[keep] - lo, vv[keep]
        L = hi - lo + 1
    else:
        base = min(ii.min(), jj.min())
        ii, jj = ii - base, jj - base
        L = int(max(ii.max(), jj.max())) + 1
    m = np.zeros((L, L), dtype=np.float64)
    np.add.at(m, (ii, jj), vv)
    np.add.at(m, (jj, ii), np.where(ii == jj, 0.0, vv))
    return m


# ---------------------------------------------------------------------------
# cooler .cool / .mcool (HDF5, via h5py when present)
# ---------------------------------------------------------------------------

def load_cooler(
    path: str | os.PathLike,
    chrom: Optional[str] = None,
    resolution: Optional[int] = None,
    balance: bool = False,
) -> np.ndarray:
    """Read a cooler file's intra-chromosomal block as a dense matrix.

    Requires h5py (gated import — raises ImportError with guidance if it is
    unavailable). For `.mcool` multi-resolution files pass `resolution`; the
    group layout is `resolutions/<res>` per the cooler schema. chrom=None
    with a single-chromosome cooler takes that chromosome.

    balance=True applies the stored matrix-balancing weights
    (`bins/weight`, the cooler convention: balanced_ij = count_ij w_i w_j);
    bins with NaN weight (filtered by the balancer) come back as zero
    rows/columns."""
    try:
        import h5py
    except ImportError as e:  # pragma: no cover - environment dependent
        raise ImportError(
            "load_cooler needs h5py; convert with cooler dump to the "
            "HiC-Pro triplet format and use load_sparse_triplet instead"
        ) from e

    with h5py.File(path, "r") as f:
        grp = f
        if "resolutions" in f:
            if resolution is None:
                raise ValueError(
                    f"{path}: multi-resolution cooler; pass resolution= "
                    f"(available: {sorted(f['resolutions'])})"
                )
            grp = f[f"resolutions/{resolution}"]
        names = [
            n.decode() if isinstance(n, bytes) else str(n)
            for n in grp["chroms/name"][:]
        ]
        if chrom is None:
            if len(names) != 1:
                raise ValueError(f"{path}: pass chrom= (available: {names})")
            chrom = names[0]
        if chrom not in names:
            raise ValueError(f"{path}: chromosome {chrom!r} not in {names}")
        cid = names.index(chrom)
        bin_chrom = grp["bins/chrom"][:]
        bin_ids = np.nonzero(bin_chrom == cid)[0]
        lo, hi = int(bin_ids.min()), int(bin_ids.max())
        L = hi - lo + 1
        b1 = grp["pixels/bin1_id"][:]
        b2 = grp["pixels/bin2_id"][:]
        cnt = grp["pixels/count"][:].astype(np.float64)
        keep = (b1 >= lo) & (b1 <= hi) & (b2 >= lo) & (b2 <= hi)
        i, j, v = b1[keep] - lo, b2[keep] - lo, cnt[keep]
        m = np.zeros((L, L), dtype=np.float64)
        np.add.at(m, (i, j), v)
        np.add.at(m, (j, i), np.where(i == j, 0.0, v))
        if balance:
            if "bins/weight" not in grp:
                raise ValueError(
                    f"{path}: balance=True but no bins/weight column "
                    "(run `cooler balance` or use ice=True instead)"
                )
            w = np.asarray(grp["bins/weight"][lo:hi + 1], dtype=np.float64)
            good = np.isfinite(w)
            wv = np.where(good, w, 0.0)
            m = m * wv[:, None] * wv[None, :]
        return m


# ---------------------------------------------------------------------------
# juicer .hic (binary; v8, BP unit, NONE normalization, pure numpy)
# ---------------------------------------------------------------------------

class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def seek(self, pos: int):
        self.pos = pos

    def read(self, fmt: str):
        vals = struct.unpack_from("<" + fmt, self.data, self.pos)
        self.pos += struct.calcsize("<" + fmt)
        return vals if len(vals) > 1 else vals[0]

    def string(self) -> str:
        end = self.data.index(b"\0", self.pos)
        s = self.data[self.pos:end].decode()
        self.pos = end + 1
        return s


def _add_records(m, recs):
    for x, y, v in recs:
        if v != v:      # float blocks use NaN as the missing-value
            continue    # sentinel (the juicer writers' convention)
        m[y, x] += v
        if x != y:
            m[x, y] += v


def _parse_block_v8(b: _Reader):
    """v8 block payload -> [(x, y, value)] (flags: useShort, blockType)."""
    n_records = b.read("i")
    x_off, y_off = b.read("ii")
    use_short = b.read("b")
    block_type = b.read("b")
    out = []
    if block_type == 1:                         # list of rows
        row_count = b.read("h")
        for _ in range(row_count):
            y = y_off + b.read("h")
            rec_count = b.read("h")
            for _ in range(rec_count):
                x = x_off + b.read("h")
                v = float(b.read("h")) if use_short else b.read("f")
                out.append((x, y, v))
    elif block_type == 2:                       # dense
        n_dense = b.read("i")
        w = b.read("h")
        for k in range(n_dense):
            v = float(b.read("h")) if use_short else b.read("f")
            if use_short and v == -32768:
                continue
            row = k // w
            col = k - row * w
            out.append((x_off + col, y_off + row, v))
    else:
        raise ValueError(f"unknown v8 block type {block_type}")
    assert n_records >= 0
    return out


def _parse_block_v9(b: _Reader):
    """v9 block payload -> [(x, y, value)]. v9 replaced v8's two flag bytes
    with four: useFloatContact, useIntXPos, useIntYPos,
    matrixRepresentation — coordinates/counts may be 16- or 32-bit per
    flag (the straw reference parser's layout)."""
    n_records = b.read("i")
    x_off, y_off = b.read("ii")
    use_float = b.read("b") == 1
    xfmt = "i" if b.read("b") == 1 else "h"     # useIntXPos
    yfmt = "i" if b.read("b") == 1 else "h"     # useIntYPos
    representation = b.read("b")
    val = (lambda: b.read("f")) if use_float else (lambda: float(b.read("h")))
    out = []
    if representation == 1:                     # list of rows
        row_count = b.read(yfmt)
        for _ in range(row_count):
            y = y_off + b.read(yfmt)
            rec_count = b.read(xfmt)
            for _ in range(rec_count):
                x = x_off + b.read(xfmt)
                out.append((x, y, val()))
    elif representation == 2:                   # dense
        n_dense = b.read("i")
        w = b.read(xfmt)
        for k in range(n_dense):
            v = val()
            if not use_float and v == -32768:
                continue
            row = k // w
            col = k - row * w
            out.append((x_off + col, y_off + row, v))
    else:
        raise ValueError(f"unknown v9 matrix representation {representation}")
    assert n_records >= 0
    return out


def _read_norm_vector(
    r: _Reader, version: int, cid: int, resolution: int, norm: str,
    n_entries_pos: int,
) -> np.ndarray:
    """Walk the footer's expected-value sections to the normalization-vector
    index and load the requested vector. Field widths follow the spec's
    v8/v9 split: vector lengths and values are int/double in v8, long/float
    in v9."""
    r.seek(n_entries_pos)
    cnt_fmt = "i" if version == 8 else "q"
    val_fmt = "d" if version == 8 else "f"

    def skip_expected(with_type: bool):
        n_vec = r.read("i")
        for _ in range(n_vec):
            if with_type:
                r.string()                      # normalization type
            r.string()                          # unit
            r.read("i")                         # binSize
            n_values = r.read(cnt_fmt)
            r.pos += struct.calcsize("<" + val_fmt) * n_values
            n_scale = r.read("i")
            r.pos += (4 + struct.calcsize("<" + val_fmt)) * n_scale

    skip_expected(with_type=False)              # expected value vectors
    skip_expected(with_type=True)               # normalized expected vectors

    n_norm = r.read("i")
    found = None
    for _ in range(n_norm):
        ntype = r.string()
        chr_idx = r.read("i")
        unit = r.string()
        bin_size = r.read("i")
        position = r.read("q")
        r.read("i" if version == 8 else "q")    # nBytes
        if (ntype == norm and chr_idx == cid and unit == "BP"
                and bin_size == resolution):
            found = position
    if found is None:
        raise ValueError(
            f"normalization vector {norm!r} not found for this "
            f"chromosome/resolution"
        )
    r.seek(found)
    n_values = r.read(cnt_fmt)
    vec = np.frombuffer(
        r.data, dtype="<f8" if version == 8 else "<f4",
        count=n_values, offset=r.pos,
    ).astype(np.float64)
    return vec


def load_hic(
    path: str | os.PathLike,
    chrom: str,
    resolution: int,
    norm: str = "NONE",
) -> np.ndarray:
    """Pure-numpy juicer `.hic` reader: versions 8 AND 9, `BP` unit,
    intra-chromosomal counts, with optional normalization (norm="KR",
    "VC", "VC_SQRT", "SCALE", ... — any vector the file carries; "NONE"
    returns raw counts). Returns the dense (L, L) matrix at `resolution`
    for `chrom`.

    Format per the public hic spec (github.com/aidenlab/hic-format):
    header (magic/version/master-pos/genome[/v9 norm-vector index pos]/
    attrs/chrs/resolutions), footer master index keyed 'c1_c2' followed by
    expected-value sections and the normalization-vector index, per-matrix
    zoom records, and zlib-compressed blocks of (binX, binY, count)
    records. v8/v9 differences handled: 64-bit chromosome sizes, the v9
    footer's long nBytesV5, float (vs double) vector values, long (vs int)
    vector lengths, and the v9 block flag layout (_parse_block_v9).
    Normalized counts are raw / (v[binX] * v[binY]); bins with zero/NaN
    norm entries come back as zero rows (the juicer convention)."""
    with open(path, "rb") as f:
        r = _Reader(f.read())

    magic = r.string()
    if magic != "HIC":
        raise ValueError(f"{path}: not a .hic file (magic {magic!r})")
    version = r.read("i")
    if version not in (8, 9):
        raise ValueError(
            f"{path}: unsupported .hic version {version} (need 8 or 9)"
        )
    master_pos = r.read("q")
    r.string()                                  # genomeId
    if version >= 9:
        r.read("qq")                            # normVectorIndex pos/length
    n_attrs = r.read("i")
    for _ in range(n_attrs):
        r.string(), r.string()
    n_chrs = r.read("i")
    chrom_names: List[str] = []
    chrom_sizes: List[int] = []
    for _ in range(n_chrs):
        chrom_names.append(r.string())
        chrom_sizes.append(r.read("i" if version == 8 else "q"))
    if chrom not in chrom_names:
        raise ValueError(f"{path}: chromosome {chrom!r} not in {chrom_names}")
    cid = chrom_names.index(chrom)
    n_res = r.read("i")
    resolutions = [r.read("i") for _ in range(n_res)]
    if resolution not in resolutions:
        raise ValueError(
            f"{path}: resolution {resolution} not in {resolutions}"
        )
    L = -(-chrom_sizes[cid] // resolution)

    # footer: master index (v9's nBytesV5 widened to a long)
    r.seek(master_pos)
    r.read("i" if version == 8 else "q")        # nBytesV5
    n_entries = r.read("i")
    entry: Dict[str, Tuple[int, int]] = {}
    for _ in range(n_entries):
        key = r.string()
        position, size = r.read("qi")
        entry[key] = (position, size)
    norm_sections_pos = r.pos                   # expected/norm vectors follow
    key = f"{cid}_{cid}"
    if key not in entry:
        raise ValueError(f"{path}: no intra block for {chrom} ({key})")

    # matrix record
    r.seek(entry[key][0])
    r.read("ii")                                # chr1Idx, chr2Idx
    n_zooms = r.read("i")
    blocks: List[Tuple[int, int]] = []
    for _ in range(n_zooms):
        unit = r.string()
        r.read("i")                             # zoom index
        r.read("fiff")                          # sumCounts, occupied, p5, p95
        bin_size = r.read("i")
        r.read("ii")                            # blockBinCount, blockColumnCount
        n_blocks = r.read("i")
        these = []
        for _ in range(n_blocks):
            r.read("i")                         # block number
            fpos, fsize = r.read("qi")
            these.append((fpos, fsize))
        if unit == "BP" and bin_size == resolution:
            blocks = these
    if not blocks:
        raise ValueError(f"{path}: no BP blocks at resolution {resolution}")

    m = np.zeros((L, L), dtype=np.float64)
    parse = _parse_block_v8 if version == 8 else _parse_block_v9
    for fpos, fsize in blocks:
        raw = zlib.decompress(r.data[fpos:fpos + fsize])
        _add_records(m, parse(_Reader(raw)))

    if norm != "NONE":
        vec = _read_norm_vector(
            r, version, cid, resolution, norm, norm_sections_pos
        )
        if len(vec) < L:
            vec = np.pad(vec, (0, L - len(vec)), constant_values=np.nan)
        vec = vec[:L]
        good = np.isfinite(vec) & (vec != 0.0)
        denom = np.where(good, vec, 1.0)
        m = m / denom[:, None] / denom[None, :]
        m[~good, :] = 0.0
        m[:, ~good] = 0.0
    return m


def ice_balance(
    m: np.ndarray,
    max_iter: int = 200,
    tol: float = 1e-5,
    min_coverage_frac: float = 0.1,
) -> np.ndarray:
    """ICE (iterative correction / matrix balancing, Imakaev 2012) for raw
    Hi-C counts: find a bias vector b so that the corrected matrix
    m_ij / (b_i b_j) has equal row sums. Pure numpy, O(iter * L^2).

    Bins with coverage below min_coverage_frac of the nonzero-bin mean are
    masked out of the iteration (the standard low-coverage filter) and their
    rows/cols come back zero. The corrected matrix is rescaled so its mean
    matches the input's — if_to_dist's K * mean(IF^a) normalization then
    behaves identically on balanced and raw inputs."""
    m = np.asarray(m, dtype=np.float64)
    L = m.shape[0]
    cov = m.sum(axis=1)
    nz = cov > 0
    good = nz.copy()
    if nz.any():
        good &= cov >= min_coverage_frac * cov[nz].mean()
    w = np.where(good[:, None] & good[None, :], m, 0.0)
    bias = np.ones(L)
    for _ in range(max_iter):
        s = w.sum(axis=1)
        s_nz = s[good]
        if s_nz.size == 0:
            break
        d = np.ones(L)
        d[good] = s[good] / s_nz.mean()
        w = w / d[:, None] / d[None, :]
        bias *= d
        if np.abs(d[good] - 1.0).max() < tol:
            break
    # rescale to the input's overall intensity so downstream K scaling is
    # unchanged in expectation
    if w.sum() > 0:
        w *= m[good][:, good].sum() / w.sum() if good.any() else 1.0
    return w


def load_any(
    path: str | os.PathLike,
    chrom: Optional[str] = None,
    resolution: Optional[int] = None,
    bed_path: Optional[str | os.PathLike] = None,
    norm: str = "NONE",
) -> np.ndarray:
    """Dispatch on extension: .cool/.mcool -> cooler, .hic -> juicer,
    .matrix -> HiC-Pro triplets, anything else -> the reference's dense
    whitespace text format. norm: for .hic, a stored normalization vector
    name (KR/VC/SCALE...); for .cool/.mcool, any non-NONE value applies
    the stored `bins/weight` balancing."""
    p = os.fspath(path)
    if p.endswith((".cool", ".mcool")):
        return load_cooler(p, chrom, resolution,
                           balance=norm not in ("NONE", "", None))
    if p.endswith(".hic"):
        if chrom is None or resolution is None:
            raise ValueError(".hic input needs chrom= and resolution=")
        return load_hic(p, chrom, resolution, norm=norm)
    if p.endswith(".matrix"):
        return load_sparse_triplet(p, bed_path, chrom)
    from chromosome3d.io.matrix import load_if_matrix

    return load_if_matrix(p)
