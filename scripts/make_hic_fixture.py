#!/usr/bin/env python3
"""Generate FROZEN binary Hi-C fixtures for tests/assets/.

Hand-assembles juicer `.hic` (v8 and v9) and cooler `.cool` files directly
from the PUBLISHED format specs (github.com/aidenlab/hic-format; the cooler
HDF5 schema) — deliberately importing NOTHING from chromosome3d, so the
repo's readers are exercised against an independent spec interpretation.
The expected dense matrices are computed straight from the record lists
chosen here and frozen alongside as .npy.

This script is run ONCE; its outputs are committed. The point of freezing
(rather than generating in-test) is that a later change to the repo's
readers — or to this generator — can no longer co-evolve with the bytes:
any drift from the committed assets fails the test. (A public reference
file would be better still; this environment has no network egress, so a
spec-following frozen blob is the closest available substitute, and it at
least breaks the reader-tests-its-own-writer symmetry the round-3 VERDICT
flagged.)

Spec corners covered:
  .hic v8 : list block (short values), dense block (float values with NaN
            sentinel records), two chromosomes + an unused resolution (the
            reader must pick the right zoom/matrix), expected-value section
            in the footer, a KR normalization vector (double values).
  .hic v9 : long chromosome sizes, the four v9 block flag bytes with int
            x-positions + short y-positions, float contacts, long footer
            nBytesV5, float norm-vector values with long counts.
  .cool   : two chromosomes (bin-id offsetting), upper-triangle pixels,
            a weight column with one NaN (balanced load must zero it).
"""

import os
import struct
import sys
import zlib

import numpy as np

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "tests", "assets")


def s(x):
    return x.encode() + b"\0"


class W:
    def __init__(self):
        self.b = bytearray()

    def pack(self, fmt, *vals):
        self.b += struct.pack("<" + fmt, *vals)

    def raw(self, data):
        self.b += data

    def pos(self):
        return len(self.b)


# --------------------------------------------------------------------------
# the contact records (binX, binY, count) for chromosome "chrF" (L = 6 bins
# at resolution 100); a second chromosome "chrU" exists but carries no
# matrix (the reader must error if asked for it with no block)
# --------------------------------------------------------------------------
RES = 100
CHRF_SIZE = 550          # -> ceil(550/100) = 6 bins
CHRU_SIZE = 250

# block 1 (list layout, short counts)
LIST_RECORDS = [(0, 0, 9.0), (1, 0, 4.0), (3, 2, 7.0), (4, 4, 2.0)]
# block 2 (dense layout, float counts, one NaN slot); the dense window is
# rows 4..5 x cols 2..4 (w = 3), laid out row-major
DENSE_XOFF, DENSE_YOFF, DENSE_W = 2, 4, 3
DENSE_VALUES = [5.5, float("nan"), 1.25,      # row y=4: x=2, 3, 4
                0.75, 3.0, float("nan")]      # row y=5: x=2, 3, 4

KR_VECTOR = [1.0, 2.0, 0.5, 1.0, 4.0, 1.0]


def expected_matrix(norm=None):
    m = np.zeros((6, 6))

    def add(x, y, v):
        m[y, x] += v
        if x != y:
            m[x, y] += v

    for x, y, v in LIST_RECORDS:
        add(x, y, v)
    for k, v in enumerate(DENSE_VALUES):
        if v == v:
            add(DENSE_XOFF + k % DENSE_W, DENSE_YOFF + k // DENSE_W, v)
    if norm is not None:
        vec = np.asarray(norm)
        m = m / vec[:, None] / vec[None, :]
    return m


def block_list_v8():
    w = W()
    w.pack("i", len(LIST_RECORDS))
    w.pack("ii", 0, 0)                       # binXOffset, binYOffset
    w.pack("b", 1)                           # useShort
    w.pack("b", 1)                           # blockType: list of rows
    rows = {}
    for x, y, v in LIST_RECORDS:
        rows.setdefault(y, []).append((x, v))
    w.pack("h", len(rows))
    for y in sorted(rows):
        w.pack("h", y)                       # row number (relative to yOff)
        w.pack("h", len(rows[y]))
        for x, v in sorted(rows[y]):
            w.pack("h", x)
            w.pack("h", int(v))
    return zlib.compress(bytes(w.b))


def block_dense_v8():
    w = W()
    n_real = sum(1 for v in DENSE_VALUES if v == v)
    w.pack("i", n_real)
    w.pack("ii", DENSE_XOFF, DENSE_YOFF)
    w.pack("b", 0)                           # useShort = false -> float
    w.pack("b", 2)                           # blockType: dense
    w.pack("i", len(DENSE_VALUES))
    w.pack("h", DENSE_W)
    for v in DENSE_VALUES:
        w.pack("f", v)
    return zlib.compress(bytes(w.b))


def block_list_v9():
    """v9 list block: float contacts, INT x positions, SHORT y positions."""
    w = W()
    w.pack("i", len(LIST_RECORDS))
    w.pack("ii", 0, 0)
    w.pack("b", 1)                           # useFloatContact
    w.pack("b", 1)                           # useIntXPos
    w.pack("b", 0)                           # useIntYPos -> short
    w.pack("b", 1)                           # representation: list
    rows = {}
    for x, y, v in LIST_RECORDS:
        rows.setdefault(y, []).append((x, v))
    w.pack("h", len(rows))
    for y in sorted(rows):
        w.pack("h", y)
        w.pack("i", len(rows[y]))
        for x, v in sorted(rows[y]):
            w.pack("i", x)
            w.pack("f", v)
    return zlib.compress(bytes(w.b))


def block_dense_v9():
    """v9 dense block: short contacts (-32768 sentinel), short positions."""
    w = W()
    n_real = sum(1 for v in DENSE_VALUES if v == v)
    w.pack("i", n_real)
    w.pack("ii", DENSE_XOFF, DENSE_YOFF)
    w.pack("b", 0)                           # useFloatContact = false
    w.pack("b", 0)                           # useIntXPos -> short
    w.pack("b", 0)                           # useIntYPos -> short
    w.pack("b", 2)                           # representation: dense
    w.pack("i", len(DENSE_VALUES))
    w.pack("h", DENSE_W)
    for v in DENSE_VALUES:
        # v9 short-dense uses -32768 as the missing sentinel; our NaN slots
        # become sentinels, real values round to shorts (values are chosen
        # integral-after-x4 so we scale by 4 to keep them integral? no —
        # keep it simple: use integral values only in the v9 dense block)
        w.pack("h", -32768 if v != v else int(v * 4))
    return zlib.compress(bytes(w.b))


def expected_matrix_v9():
    """v9 fixture uses the same list records but a x4-scaled integral dense
    block (short contacts can't carry 5.5)."""
    m = np.zeros((6, 6))

    def add(x, y, v):
        m[y, x] += v
        if x != y:
            m[x, y] += v

    for x, y, v in LIST_RECORDS:
        add(x, y, v)
    for k, v in enumerate(DENSE_VALUES):
        if v == v:
            add(DENSE_XOFF + k % DENSE_W, DENSE_YOFF + k // DENSE_W,
                float(int(v * 4)))
    return m


def make_hic(version: int) -> bytes:
    w = W()
    w.raw(s("HIC"))
    w.pack("i", version)
    master_pos_slot = w.pos()
    w.pack("q", 0)                           # master index position (patched)
    w.raw(s("test-genome"))
    if version >= 9:
        nvi_slot = w.pos()
        w.pack("qq", 0, 0)                   # normVectorIndex pos/len (patched)
    w.pack("i", 2)                           # attributes
    w.raw(s("software")), w.raw(s("make_hic_fixture.py"))
    w.raw(s("nviIndex")), w.raw(s("frozen"))
    w.pack("i", 2)                           # chromosomes
    w.raw(s("chrF"))
    w.pack("i" if version == 8 else "q", CHRF_SIZE)
    w.raw(s("chrU"))
    w.pack("i" if version == 8 else "q", CHRU_SIZE)
    w.pack("i", 2)                           # BP resolutions
    w.pack("i", RES)
    w.pack("i", 1000)                        # a second, blockless resolution
    w.pack("i", 0)                           # fragment resolutions

    # ---- blocks (body) ----
    b1 = block_list_v8() if version == 8 else block_list_v9()
    b2 = block_dense_v8() if version == 8 else block_dense_v9()
    b1_pos = w.pos(); w.raw(b1)
    b2_pos = w.pos(); w.raw(b2)

    # ---- matrix record for chrF (cid 0) ----
    matrix_pos = w.pos()
    w.pack("ii", 0, 0)                       # chr1Idx, chr2Idx
    w.pack("i", 1)                           # nResolutions (zoom records)
    w.raw(s("BP"))
    w.pack("i", 0)                           # zoom index
    w.pack("f", 32.5); w.pack("i", 9)        # sumCounts, occupiedCellCount
    w.pack("ff", 0.0, 9.0)                   # percentile5, percentile95
    w.pack("i", RES)                         # binSize
    w.pack("ii", 6, 1)                       # blockBinCount, blockColumnCount
    w.pack("i", 2)                           # blockCount
    w.pack("i", 0); w.pack("q", b1_pos); w.pack("i", len(b1))
    w.pack("i", 1); w.pack("q", b2_pos); w.pack("i", len(b2))

    # ---- norm vector payload ----
    nv_pos = w.pos()
    if version == 8:
        w.pack("i", len(KR_VECTOR))
        for v in KR_VECTOR:
            w.pack("d", v)
    else:
        w.pack("q", len(KR_VECTOR))
        for v in KR_VECTOR:
            w.pack("f", v)

    # ---- footer / master index ----
    master_pos = w.pos()
    w.pack("i" if version == 8 else "q", 0)  # nBytesV5 (unused by readers here)
    w.pack("i", 1)                           # nEntries
    w.raw(s("0_0"))
    w.pack("q", matrix_pos); w.pack("i", 0)  # size unused by the reader
    # expected-value vectors: one, with a chr scale factor (readers skip)
    w.pack("i", 1)
    w.raw(s("BP")); w.pack("i", RES)
    if version == 8:
        w.pack("i", 3); w.pack("ddd", 1.0, 2.0, 3.0)
    else:
        w.pack("q", 3); w.pack("fff", 1.0, 2.0, 3.0)
    w.pack("i", 1)                           # nChrScaleFactors
    w.pack("i", 0)
    w.pack("d" if version == 8 else "f", 1.5)
    # normalized expected-value vectors: one (with leading type string)
    w.pack("i", 1)
    w.raw(s("KR"))
    w.raw(s("BP")); w.pack("i", RES)
    if version == 8:
        w.pack("i", 2); w.pack("dd", 1.0, 1.0)
    else:
        w.pack("q", 2); w.pack("ff", 1.0, 1.0)
    w.pack("i", 0)                           # nChrScaleFactors
    # normalization vector index
    nvi_pos = w.pos()
    w.pack("i", 2)
    w.raw(s("KR")); w.pack("i", 0)           # type, chrIdx
    w.raw(s("BP")); w.pack("i", RES)
    w.pack("q", nv_pos)
    nv_bytes = (4 + 8 * len(KR_VECTOR)) if version == 8 else (8 + 4 * len(KR_VECTOR))
    w.pack("i" if version == 8 else "q", nv_bytes)
    w.raw(s("KR")); w.pack("i", 1)           # a chrU decoy entry
    w.raw(s("BP")); w.pack("i", RES)
    w.pack("q", nv_pos)
    w.pack("i" if version == 8 else "q", nv_bytes)

    data = bytearray(w.b)
    struct.pack_into("<q", data, master_pos_slot, master_pos)
    if version >= 9:
        struct.pack_into("<qq", data, nvi_slot, nvi_pos, len(w.b) - nvi_pos)
    return bytes(data)


def make_cool(path: str):
    import h5py

    # chrA: 4 bins of 100; chrB: 3 bins of 100 (bin ids 4..6)
    pixels = [  # (bin1, bin2, count) — upper triangle, cooler convention
        (0, 0, 10), (0, 2, 3), (1, 3, 5), (2, 2, 7),
        (4, 5, 2), (5, 6, 6), (4, 4, 9),       # chrB block
        (1, 5, 99),                             # inter-chromosomal (excluded)
    ]
    weights = [1.0, 0.5, float("nan"), 2.0, 1.0, 1.0, 0.25]
    with h5py.File(path, "w") as f:
        f.attrs["format"] = "HDF5::Cooler"
        f.attrs["bin-size"] = 100
        f.create_dataset("chroms/name", data=np.array([b"chrA", b"chrB"]))
        f.create_dataset("chroms/length", data=np.array([400, 300], np.int32))
        f.create_dataset(
            "bins/chrom", data=np.array([0, 0, 0, 0, 1, 1, 1], np.int32)
        )
        f.create_dataset(
            "bins/start",
            data=np.array([0, 100, 200, 300, 0, 100, 200], np.int32),
        )
        f.create_dataset(
            "bins/end",
            data=np.array([100, 200, 300, 400, 100, 200, 300], np.int32),
        )
        f.create_dataset("bins/weight", data=np.array(weights, np.float64))
        f.create_dataset(
            "pixels/bin1_id", data=np.array([p[0] for p in pixels], np.int64)
        )
        f.create_dataset(
            "pixels/bin2_id", data=np.array([p[1] for p in pixels], np.int64)
        )
        f.create_dataset(
            "pixels/count", data=np.array([p[2] for p in pixels], np.int32)
        )

    # expected dense chrA block
    ma = np.zeros((4, 4))
    for b1, b2, c in pixels:
        if b1 <= 3 and b2 <= 3:
            ma[b1, b2] += c
            if b1 != b2:
                ma[b2, b1] += c
    # balanced: count * w_i * w_j, NaN weights -> zero rows
    wv = np.array(weights[:4])
    good = np.isfinite(wv)
    wz = np.where(good, wv, 0.0)
    mb = ma * wz[:, None] * wz[None, :]
    return ma, mb


def main():
    os.makedirs(OUT, exist_ok=True)
    for version in (8, 9):
        blob = make_hic(version)
        with open(os.path.join(OUT, f"fixture_v{version}.hic"), "wb") as f:
            f.write(blob)
        exp = expected_matrix() if version == 8 else expected_matrix_v9()
        np.save(os.path.join(OUT, f"fixture_v{version}_none.npy"), exp)
        kr = np.asarray(KR_VECTOR)
        np.save(
            os.path.join(OUT, f"fixture_v{version}_kr.npy"),
            exp / kr[:, None] / kr[None, :],
        )
        print(f"v{version}: {len(blob)} bytes, sum={exp.sum():.2f}")
    ma, mb = make_cool(os.path.join(OUT, "fixture.cool"))
    np.save(os.path.join(OUT, "fixture_cool_raw.npy"), ma)
    np.save(os.path.join(OUT, "fixture_cool_balanced.npy"), mb)
    print(f"cool: chrA sum={ma.sum():.2f} balanced sum={mb.sum():.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
