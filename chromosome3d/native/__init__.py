"""Native (C++) runtime components.

The reference's single native dependency is the external CNS Fortran suite
(the solver — reimplemented in JAX in ops/ + solver/). The remaining
host-side hot paths — parsing large whitespace IF matrices and PDB emission —
get a C++ fast path here, loaded via ctypes with a pure-Python fallback.

Build: `make -C chromosome3d/native`.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

_LIB = None
_TRIED = False


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    here = os.path.dirname(__file__)
    for name in ("libc3d_native.so",):
        path = os.path.join(here, name)
        if os.path.exists(path):
            try:
                lib = ctypes.CDLL(path)
                lib.c3d_parse_matrix.restype = ctypes.c_longlong
                lib.c3d_parse_matrix.argtypes = [
                    ctypes.c_char_p,
                    ctypes.POINTER(ctypes.c_double),
                    ctypes.c_longlong,
                ]
                lib.c3d_matrix_dims.restype = ctypes.c_longlong
                lib.c3d_matrix_dims.argtypes = [ctypes.c_char_p]
                lib.c3d_write_ca_pdb_v2.restype = ctypes.c_int32
                lib.c3d_write_ca_pdb_v2.argtypes = [
                    ctypes.c_char_p,
                    ctypes.POINTER(ctypes.c_double),
                    ctypes.c_longlong,
                    ctypes.c_char_p,
                    ctypes.c_char_p,
                    ctypes.c_int32,
                ]
                lib.c3d_write_dist.restype = ctypes.c_int32
                lib.c3d_write_dist.argtypes = [
                    ctypes.c_char_p,
                    ctypes.POINTER(ctypes.c_double),
                    ctypes.c_longlong,
                ]
                lib.c3d_write_rr_rows.restype = ctypes.c_int32
                lib.c3d_write_rr_rows.argtypes = [
                    ctypes.c_char_p,
                    ctypes.POINTER(ctypes.c_int32),
                    ctypes.POINTER(ctypes.c_int32),
                    ctypes.POINTER(ctypes.c_double),
                    ctypes.c_longlong,
                ]
                lib.c3d_rr_to_tbl.restype = ctypes.c_longlong
                lib.c3d_rr_to_tbl.argtypes = [
                    ctypes.c_char_p,
                    ctypes.c_char_p,
                    ctypes.c_double,
                    ctypes.c_double,
                ]
                _LIB = lib
            except (OSError, AttributeError):
                # missing symbol = stale .so from an older ABI; rebuild needed
                _LIB = None
            break
    return _LIB


def available() -> bool:
    return _load() is not None


def parse_matrix(path: str) -> Optional[np.ndarray]:
    """Parse a whitespace-float matrix file; None if the native lib is absent
    or the file is not a well-formed square grid of numeric tokens with
    uniform row widths (caller falls back to Python, which applies the same
    acceptance rule and raises the descriptive error — so behavior is
    identical with or without the .so built)."""
    lib = _load()
    if lib is None:
        return None
    side = lib.c3d_matrix_dims(path.encode())
    if side <= 0:
        return None
    n = side * side
    buf = np.empty(n, dtype=np.float64)
    got = lib.c3d_parse_matrix(
        path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n
    )
    if got != side:
        return None
    return buf.reshape(side, side)


def write_ca_pdb(
    path: str,
    coords: np.ndarray,
    header: str = "",
    resname: str = "MET",
    connect: bool = True,
) -> bool:
    """Native CA-bead PDB emission (byte-identical to io.pdb.write_ca_pdb;
    parity-tested). header: pre-formatted REMARK lines incl. trailing
    newlines. Returns False when the library is absent or the write failed —
    the caller falls back to the Python writer."""
    lib = _load()
    if lib is None:
        return False
    xyz = np.ascontiguousarray(coords, dtype=np.float64)
    if xyz.ndim != 2 or xyz.shape[1] != 3:
        return False
    rc = lib.c3d_write_ca_pdb_v2(
        str(path).encode(),
        xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        xyz.shape[0],
        header.encode(),
        resname.encode(),
        1 if connect else 0,
    )
    return rc == 0


def write_dist(path: str, dist: np.ndarray) -> bool:
    """Native `$ID.dist` emission ("%.1f " cells; byte-parity-tested).
    False = library absent/failed; caller falls back to Python."""
    lib = _load()
    if lib is None:
        return False
    m = np.ascontiguousarray(dist, dtype=np.float64)
    if m.ndim != 2 or m.shape[0] != m.shape[1]:
        return False
    rc = lib.c3d_write_dist(
        str(path).encode(),
        m.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        m.shape[0],
    )
    return rc == 0


def write_rr_rows(path: str, ii: np.ndarray, jj: np.ndarray,
                  dd: np.ndarray) -> bool:
    """Native `$ID.rr` row emission for PRE-ORDERED (i, j, d) arrays
    ('i j %.2f %.2f 1.0'; byte-parity-tested)."""
    lib = _load()
    if lib is None:
        return False
    i32 = np.ascontiguousarray(ii, dtype=np.int32)
    j32 = np.ascontiguousarray(jj, dtype=np.int32)
    d64 = np.ascontiguousarray(dd, dtype=np.float64)
    if not (len(i32) == len(j32) == len(d64)):
        return False
    rc = lib.c3d_write_rr_rows(
        str(path).encode(),
        i32.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        j32.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        d64.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        len(d64),
    )
    return rc == 0


def rr_to_tbl(rr_path: str, tbl_path: str, zero_d: float,
              zero_neg: float):
    """Native carr2tbl (incl. the literal lo=='0' string special case).
    Returns the row count, or None when the library is absent/failed."""
    lib = _load()
    if lib is None:
        return None
    n = lib.c3d_rr_to_tbl(
        str(rr_path).encode(), str(tbl_path).encode(),
        float(zero_d), float(zero_neg),
    )
    return None if n < 0 else int(n)
