"""Fused pair energy + gradient kernel for the GPU (Pallas, Triton route).

Computes what ops.pair.row_block_energy_grad computes, in one pass that
never writes an (L, L) intermediate to device memory:

  * grid (B, row blocks), the structure index fastest: the B programs of
    one row block run back to back and read the same restraint tiles, so
    the ensemble's shared (L, L) tensors come from L2 for all but the
    first structure;
  * each program owns BLOCK_M rows (a power of two) and loops over column
    blocks of BLOCK_N; masked loads handle L and row counts that are not
    multiples of the blocks;
  * the gradient sum_j c_ij (x_i - x_j) is three float32 FMA chains (N = 3
    is too narrow for the tensor cores, and this keeps TF32 out); the five
    sums (two energies, three gradient components) accumulate elementwise
    in (BLOCK_M, BLOCK_N) registers and are reduced over the row once, after
    the column loop, so no cross-thread shuffle runs per column block;
    energies are per-row partials summed outside;
  * bf16-stored tiles (AnnealConfig.pair_bf16) are converted on load.

`row0` is the global index of the tiles' first row: 0 for a whole-matrix
call, the shard's row offset in the row-sharded solver.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from chromosome3d.ops.energy import EnergyWeights

_EPS = 1e-12
# launch defaults: the fastest of the block shapes timed on an H100 at both
# the headline (L = 456, B = 20) and the at-scale (L = 10,240, B = 8) shape
# (scripts/pair_kernel_ab.py)
BLOCK_M = 16
BLOCK_N = 64
NUM_WARPS = 4
NUM_STAGES = 2


def _kernel(params_ref, row0_ref, xt_ref, bead_ref, *refs, exact, n_rows,
            block_m, block_n):
    if exact:
        t_ref, w_ref, e_ref, g_ref = refs
    else:
        lo_ref, hi_ref, w_ref, e_ref, g_ref = refs
    L = xt_ref.shape[2]
    b = pl.program_id(0)
    i = pl.program_id(1)
    noe_w = params_ref[0]
    vdw_w = params_ref[1]
    vdw_radius = params_ref[2]
    rswitch = params_ref[3]
    row0 = row0_ref[0]

    local = i * block_m + jnp.arange(block_m)
    row_ok = local < n_rows
    grow = row0 + local
    rsl = pl.ds(i * block_m, block_m)
    gsl = pl.ds(row0 + i * block_m, block_m)
    ax = plgpu.load(xt_ref.at[b, 0, gsl], mask=row_ok, other=0.0)
    ay = plgpu.load(xt_ref.at[b, 1, gsl], mask=row_ok, other=0.0)
    az = plgpu.load(xt_ref.at[b, 2, gsl], mask=row_ok, other=0.0)
    bm_r = plgpu.load(bead_ref.at[gsl], mask=row_ok, other=0.0)

    def tile(ref, csl, m2):
        return plgpu.load(ref.at[rsl, csl], mask=m2, other=0.0).astype(
            jnp.float32
        )

    def body(j, carry):
        e_noe, e_vdw, gx, gy, gz = carry
        cols = j * block_n + jnp.arange(block_n)
        col_ok = cols < L
        csl = pl.ds(j * block_n, block_n)
        m2 = row_ok[:, None] & col_ok[None, :]
        xx = plgpu.load(xt_ref.at[b, 0, csl], mask=col_ok, other=0.0)
        xy = plgpu.load(xt_ref.at[b, 1, csl], mask=col_ok, other=0.0)
        xz = plgpu.load(xt_ref.at[b, 2, csl], mask=col_ok, other=0.0)
        bm_c = plgpu.load(bead_ref.at[csl], mask=col_ok, other=0.0)

        dx = ax[:, None] - xx[None, :]
        dy = ay[:, None] - xy[None, :]
        dz = az[:, None] - xz[None, :]
        d2 = dx * dx + dy * dy + dz * dz + _EPS
        rinv = jax.lax.rsqrt(d2)
        d = d2 * rinv
        pv = bm_r[:, None] * bm_c[None, :]
        w = tile(w_ref, csl, m2) * pv
        if exact:
            dev = d - tile(t_ref, csl, m2)
            well = dev * dev
            c_noe = (2.0 * noe_w) * w * dev
        else:
            over = jnp.maximum(d - tile(hi_ref, csl, m2), 0.0)
            under = jnp.maximum(tile(lo_ref, csl, m2) - d, 0.0)
            viol = over + under
            quad = viol <= rswitch
            well = jnp.where(
                quad, viol * viol,
                rswitch * rswitch + 2.0 * rswitch * (viol - rswitch),
            )
            dwell = jnp.where(quad, 2.0 * viol, 2.0 * rswitch)
            sgn = jnp.where(over > 0.0, 1.0, jnp.where(under > 0.0, -1.0, 0.0))
            c_noe = noe_w * w * dwell * sgn

        nb = jnp.where(jnp.abs(grow[:, None] - cols[None, :]) >= 2, pv, 0.0)
        overlap = jnp.maximum(vdw_radius - d, 0.0)
        c = (c_noe - (2.0 * vdw_w) * nb * overlap) * rinv
        return (e_noe + w * well, e_vdw + nb * overlap * overlap,
                gx + c * dx, gy + c * dy, gz + c * dz)

    zero = jnp.zeros((block_m, block_n), jnp.float32)
    acc = jax.lax.fori_loop(
        0, pl.cdiv(L, block_n), body, (zero, zero, zero, zero, zero)
    )
    e_noe, e_vdw, gx, gy, gz = (jnp.sum(a, axis=1) for a in acc)
    e = 0.5 * noe_w * e_noe + 0.5 * vdw_w * e_vdw
    plgpu.store(e_ref.at[b, rsl], e, mask=row_ok)
    plgpu.store(g_ref.at[b, 0, rsl], gx, mask=row_ok)
    plgpu.store(g_ref.at[b, 1, rsl], gy, mask=row_ok)
    plgpu.store(g_ref.at[b, 2, rsl], gz, mask=row_ok)


@functools.partial(
    jax.jit,
    static_argnames=("interpret", "block_m", "block_n", "num_warps",
                     "num_stages"),
)
def pair_kernel_energy_grad(
    xs: jnp.ndarray,          # (B, L, 3)
    tiles: tuple,             # (target, w) exact | (lo, hi, w) general; (Lb, L)
    bead_mask: jnp.ndarray,   # (L,)
    weights: EnergyWeights,
    row0=0,
    *,
    interpret: bool = False,
    block_m: int = BLOCK_M,
    block_n: int = BLOCK_N,
    num_warps: int = NUM_WARPS,
    num_stages: int = NUM_STAGES,
):
    """Pair energies (B,) and gradient rows (B, Lb, 3) for tiles holding
    rows [row0, row0 + Lb) of the restraint matrices."""
    B, L, _ = xs.shape
    n_rows = tiles[0].shape[0]
    exact = len(tiles) == 2
    xt = jnp.swapaxes(xs.astype(jnp.float32), 1, 2)          # (B, 3, L)
    params = jnp.stack([
        jnp.asarray(weights.noe, jnp.float32),
        jnp.asarray(weights.vdw, jnp.float32),
        jnp.asarray(weights.vdw_radius, jnp.float32),
        jnp.asarray(weights.noe_rswitch, jnp.float32),
    ])
    row0 = jnp.reshape(jnp.asarray(row0, jnp.int32), (1,))
    kernel = functools.partial(
        _kernel, exact=exact, n_rows=n_rows, block_m=block_m,
        block_n=block_n,
    )
    e_rows, g = pl.pallas_call(
        kernel,
        grid=(B, pl.cdiv(n_rows, block_m)),
        out_shape=[
            jax.ShapeDtypeStruct((B, n_rows), jnp.float32),
            jax.ShapeDtypeStruct((B, 3, n_rows), jnp.float32),
        ],
        compiler_params=plgpu.CompilerParams(
            num_warps=num_warps, num_stages=num_stages
        ),
        interpret=interpret,
        name="pair_energy_grad",
    )(params, row0, xt, bead_mask.astype(jnp.float32), *tiles)
    return jnp.sum(e_rows, axis=1), jnp.swapaxes(g, 1, 2)
