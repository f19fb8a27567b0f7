"""Row-sharded energy + gradient: the sequence-parallel (sp) axis.

At the shipped problem sizes (L <= 663) one device trivially holds the
(L, L) energy (SURVEY.md section 5), but the framework is built for
production scale: for ultra-high-resolution Hi-C (L in the tens of
thousands) the L x L restraint tensors outgrow one device's memory. The
recipe:

  * coordinates X (L, 3) are tiny — replicate them (the all-gather is O(L));
  * the (L, L) restraint tensors are sharded by ROW BLOCK over the `beads`
    mesh axis — they never move;
  * each device computes the energy partial + the gradient rows for its
    block (full-row convention: each unordered pair is seen by both
    endpoints' rows, so no gradient communication at all);
  * one psum of the scalar energy partials crosses the interconnect per
    step.

Implemented with shard_map over ops.pair.row_block_energy_grad (the same
function the single-device solver runs with row_start=0); composes with
the `chrom` data-parallel axis (vmap/jit outside) into a 2-D mesh.
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh, PartitionSpec as P

from chromosome3d.ops.energy import DenseRestraints, EnergyWeights
from chromosome3d.ops.pair import row_block_energy_grad


def make_sharded_energy_grad(mesh: Mesh, weights: EnergyWeights, axis: str = "beads"):
    """Build a shard_map'ed (energy, grad) function over `axis` of `mesh`.

    Inputs: coords (L, 3) + DenseRestraints with (L, L) tensors (rows will be
    sharded over `axis`; L must divide by the axis size) + bead_mask (L,).
    Returns (total pair energy scalar, grad (L, 3)). Bond term excluded
    (O(L); callers add it replicated, ops.pair.bonded_energy).
    """
    n = mesh.shape[axis]

    def shard_fn(x, lo, hi, w, bead_mask):
        idx = jax.lax.axis_index(axis)
        Lb = lo.shape[0]
        row_start = idx * Lb
        e_noe, e_vdw, g_rows = row_block_energy_grad(
            x, lo, hi, w, bead_mask, row_start, weights
        )
        return jax.lax.psum(e_noe + e_vdw, axis), g_rows

    mapped = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P(axis, None), P(axis, None), P(axis, None), P()),
        out_specs=(P(), P(axis, None)),
        check_vma=False,
    )

    def fn(coords, restraints: DenseRestraints, bead_mask):
        L = coords.shape[0]
        if L % n:
            raise ValueError(f"L={L} must be a multiple of the {axis} axis size {n}")
        return mapped(
            coords,
            restraints.lo,
            restraints.hi,
            restraints.mask * restraints.weight,
            bead_mask,
        )

    return fn
