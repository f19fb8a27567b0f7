"""Analytic pair energy + gradient: the annealer's hot op.

Semantics are those of ops.energy (the dense reference it is tested
against), restricted to the O(L^2) pair terms (NOE well + vdw repel). The
gradient is written out instead of taken by autodiff:

    c_ij    = (dE/dd_ij) / d_ij                    pair force coefficient
    dE/dx_i = x_i * rowsum(c)_i - (c @ X)_i         full-row convention

Each unordered pair appears in both endpoints' rows, which is why the
energies carry the 1/2 and c does not. Columns are processed in
<= _COL_CHUNK-wide slabs with coordinate-wise squared-distance
accumulation, so no (L, L, 3) diff tensor and no autodiff residual is ever
built; peak temporaries are a few (rows, chunk) arrays.

One implementation serves every route: the single-device solver calls it
with row_start=0 over all rows, the row-sharded solver with its shard's
row block. The fused GPU kernel of ops.pair_kernel computes the same
quantities in one pass and is chosen by `use_kernel`.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from chromosome3d.ops.energy import (
    EnergyWeights,
    ExactRestraints,
    _angle_energy,
)

_EPS = 1e-12

# column-chunk width cap: peak live temporaries are a few (rows, chunk)
# arrays, so the plain path scales to any L the restraint rows fit
_COL_CHUNK = 4096


def _pick_col_chunk(L: int) -> int:
    """Largest divisor of L that is <= _COL_CHUNK (full width if none —
    pathological prime L still computes, just without the memory bound)."""
    if L <= _COL_CHUNK:
        return L
    for c in range(_COL_CHUNK, 127, -1):
        if L % c == 0:
            return c
    return L


def exact_pair_tiles(restraints):
    """(target, folded weight) of a restraint set. For the two-tensor
    ExactRestraints these are aliases of the stored tensors; for
    DenseRestraints the fold materializes once at the call site (callers
    running a scan hoist it outside the step)."""
    if isinstance(restraints, ExactRestraints):
        return (restraints.target, restraints.w)
    return (restraints.lo, restraints.mask * restraints.weight)


def pair_tiles(restraints, exact: bool):
    """The tensors the pair terms read: (target, w) for exact restraints
    (lo == hi, pure quadratic well), (lo, hi, w) otherwise. w is the
    mask-folded weight."""
    t, w = exact_pair_tiles(restraints)
    if exact:
        return (t, w)
    hi = t if isinstance(restraints, ExactRestraints) else restraints.hi
    return (restraints.lo, hi, w)


def bonded_energy(c, bead_mask, weights: EnergyWeights):
    """Chain bond + optional angle-stiffness energy of one structure: the
    O(L) bonded terms (ops.energy semantics)."""
    bond_vec = c[1:] - c[:-1]
    bond_d = jnp.sqrt(jnp.sum(bond_vec * bond_vec, -1) + _EPS)
    bond_valid = bead_mask[1:] * bead_mask[:-1]
    bdev = bond_d - weights.bond_length
    e = weights.bond * jnp.sum(bond_valid * bdev * bdev)
    return e + _angle_energy(bond_vec, bond_d, bond_valid, weights)


def row_block_energy_grad(
    x: jnp.ndarray,          # (L, 3) all coordinates
    lo: jnp.ndarray,         # (Lb, L) restraint rows [row_start, row_start+Lb)
    hi: jnp.ndarray,
    w: jnp.ndarray,          # mask-folded weights rows
    bead_mask: jnp.ndarray,  # (L,)
    row_start,               # scalar: global index of the block's first row
    weights: EnergyWeights,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """(NOE energy partial, vdw energy partial, gradient rows (Lb, 3)) of
    one row block, pair terms only. Tiles may be bf16-stored; they are
    converted on read and all math runs in float32."""
    Lb, L = lo.shape
    a = jax.lax.dynamic_slice(x, (row_start, 0), (Lb, 3))
    bm_rows = jax.lax.dynamic_slice(bead_mask, (row_start,), (Lb,))
    Lc = _pick_col_chunk(L)
    n_chunks = L // Lc
    s = weights.noe_rswitch

    def chunk(carry, c0):
        e_noe, e_vdw, crow, cx = carry
        xk = jax.lax.dynamic_slice(x, (c0, 0), (Lc, 3))
        bmk = jax.lax.dynamic_slice(bead_mask, (c0,), (Lc,))
        lok = jax.lax.dynamic_slice(lo, (0, c0), (Lb, Lc)).astype(jnp.float32)
        hik = jax.lax.dynamic_slice(hi, (0, c0), (Lb, Lc)).astype(jnp.float32)
        wk = jax.lax.dynamic_slice(w, (0, c0), (Lb, Lc)).astype(jnp.float32)

        s2 = jnp.full((Lb, Lc), _EPS, x.dtype)
        for ax3 in range(3):
            dc = a[:, ax3][:, None] - xk[:, ax3][None, :]
            s2 = s2 + dc * dc
        d = jnp.sqrt(s2)
        pair_valid = bm_rows[:, None] * bmk[None, :]

        over = jnp.maximum(d - hik, 0.0)
        under = jnp.maximum(lok - d, 0.0)
        viol = over + under
        quad = viol <= s
        well = jnp.where(quad, viol * viol, s * s + 2.0 * s * (viol - s))
        wm = wk * pair_valid
        e_noe = e_noe + 0.5 * weights.noe * jnp.sum(wm * well)
        dwell = jnp.where(quad, 2.0 * viol, 2.0 * s)
        sgn = jnp.where(over > 0.0, 1.0, jnp.where(under > 0.0, -1.0, 0.0))
        c_noe = weights.noe * wm * dwell * sgn

        rows = row_start + jax.lax.broadcasted_iota(jnp.int32, (Lb, Lc), 0)
        cols = c0 + jax.lax.broadcasted_iota(jnp.int32, (Lb, Lc), 1)
        nonbonded = (jnp.abs(rows - cols) >= 2).astype(x.dtype) * pair_valid
        overlap = jnp.maximum(weights.vdw_radius - d, 0.0)
        e_vdw = e_vdw + 0.5 * weights.vdw * jnp.sum(nonbonded * overlap * overlap)
        c_vdw = -2.0 * weights.vdw * nonbonded * overlap

        c = (c_noe + c_vdw) / d                    # (Lb, Lc)
        crow = crow + jnp.sum(c, 1)
        # float32 products: without the pin the GPU may run this in TF32
        cx = cx + jnp.matmul(c, xk, precision=jax.lax.Precision.HIGHEST)
        return (e_noe, e_vdw, crow, cx), None

    zero = jnp.zeros((), x.dtype)
    carry0 = (zero, zero, jnp.zeros((Lb,), x.dtype), jnp.zeros((Lb, 3), x.dtype))
    col0s = jnp.arange(n_chunks, dtype=jnp.int32) * Lc
    (e_noe, e_vdw, crow, cx), _ = jax.lax.scan(chunk, carry0, col0s)
    grad_rows = a * crow[:, None] - cx
    return e_noe, e_vdw, grad_rows


def pair_energy_grad_batched(
    xs: jnp.ndarray,          # (B, L, 3)
    tiles: tuple,             # pair_tiles(...) rows [row_start, row_start+Lb)
    bead_mask: jnp.ndarray,   # (L,)
    weights: EnergyWeights,
    row_start=0,
    use_kernel: bool = False,
):
    """Pair energies (B,) and gradient rows (B, Lb, 3) of a batch of
    structures sharing one restraint set. use_kernel selects the fused GPU
    kernel (ops.pair_kernel)."""
    if use_kernel:
        from chromosome3d.ops import pair_kernel

        return pair_kernel.pair_kernel_energy_grad(
            xs, tiles, bead_mask, weights, row_start
        )
    if len(tiles) == 2:
        lo = hi = tiles[0]
    else:
        lo, hi = tiles[0], tiles[1]
    e_noe, e_vdw, g = jax.vmap(
        lambda c: row_block_energy_grad(
            c, lo, hi, tiles[-1], bead_mask, row_start, weights
        )
    )(xs)
    return e_noe + e_vdw, g


def energy_and_grad_batched(xs, tiles, bead_mask, weights, use_kernel=False):
    """Total energy (B,) and gradient (B, L, 3): pair terms over all rows
    plus the bonded terms (jnp, fused by XLA around the pair call)."""
    e_pair, g_pair = pair_energy_grad_batched(
        xs, tiles, bead_mask, weights, 0, use_kernel
    )
    e_b, g_b = jax.vmap(
        jax.value_and_grad(bonded_energy), in_axes=(0, None, None)
    )(xs, bead_mask, weights)
    return e_pair + e_b, g_pair + g_b


@functools.partial(jax.custom_vjp, nondiff_argnums=(4,))
def pair_energy(x, tiles, bead_mask, weights, use_kernel=False):
    """Pair energy of one structure (L, 3), differentiable in x: the
    forward pass computes the gradient with the energy, and the backward
    pass only scales it. Restraint and weight cotangents are zeros."""
    e, _ = pair_energy_grad_batched(
        x[None], tiles, bead_mask, weights, 0, use_kernel
    )
    return e[0]


def _pair_energy_fwd(x, tiles, bead_mask, weights, use_kernel):
    e, g = pair_energy_grad_batched(
        x[None], tiles, bead_mask, weights, 0, use_kernel
    )
    return e[0], (g[0], tiles, bead_mask, weights)


def _pair_energy_bwd(use_kernel, res, ct):
    g, tiles, bead_mask, weights = res
    return (
        ct * g,
        jax.tree.map(jnp.zeros_like, tiles),
        jnp.zeros_like(bead_mask),
        jax.tree.map(jnp.zeros_like, weights),
    )


pair_energy.defvjp(_pair_energy_fwd, _pair_energy_bwd)
