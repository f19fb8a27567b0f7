from chromosome3d.io.matrix import load_if_matrix, write_dist_matrix, matrix_length
from chromosome3d.io.pdb import (
    write_ca_pdb,
    read_ca_pdb,
    read_pdb_remarks,
    reduce_model,
)

__all__ = [
    "load_if_matrix",
    "write_dist_matrix",
    "matrix_length",
    "write_ca_pdb",
    "read_ca_pdb",
    "read_pdb_remarks",
    "reduce_model",
]
