"""Sequence-parallel annealing: the full solve with the (L, L) energy
row-sharded over a `beads` mesh axis.

For L far beyond the shipped sizes (ultra-high-resolution Hi-C), one device
cannot hold the O(L^2) restraint tensors. These solvers keep coordinates and
optimizer state replicated (O(L) — tiny) and shard the quadratic work:
per step, each device computes its row block's energy partial + gradient
rows (ops.pair), the gradient is all-gathered (L*3 floats), and every
device applies the identical Adam/Langevin update.

Two entry points:
  * solve_single_sharded  — one structure from a provided x0; trajectory-
    equal to solver.anneal.solve_single (tested on a CPU mesh).
  * solve_ensemble_sharded — the FULL production program at scale: landmark
    init computed from the sharded rows (no host-fed x0), mirror-pair
    batch, hot phase, CNS-style enantiomer pick, cool + final on the
    winners — the sharded counterpart of solver.anneal.solve_ensemble_impl.
    Per step the only collectives are one psum (scalars) and one
    all-gather of (n, L, 3) gradient rows. With the GPU pair kernel on
    (solver.anneal.resolve_use_pallas) each shard runs ops.pair_kernel on
    its row block, handed the shard's global row offset.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

import optax

from chromosome3d.config import AnnealConfig
from chromosome3d.ops.energy import DenseRestraints
from chromosome3d.ops.pair import (
    bonded_energy,
    exact_pair_tiles,
    pair_energy_grad_batched,
    row_block_energy_grad,
)
from chromosome3d.solver.anneal import (
    Schedule,
    build_schedule,
    _clip_per_bead,
    _exact,
    _final_weights,
    _schedule_weights,
    resolve_use_pallas,
)
from chromosome3d.solver.init import (
    chain_metric_rows,
    clip_landmark_targets,
    landmark_indices,
    landmark_triangulate,
    relax_landmarks_block,
    relax_landmarks_lower_block,
)

_EPS = 1e-12
_BIG = 1e6


def solve_single_sharded(
    mesh: Mesh,
    restraints: DenseRestraints,
    cfg: AnnealConfig,
    key: jax.Array,
    x0: jnp.ndarray,
    bead_mask: Optional[jnp.ndarray] = None,
    schedule: Optional[Schedule] = None,
    axis: str = "beads",
):
    """Anneal one structure with row-sharded energy. Returns (coords, history).

    L must be a multiple of the `beads` axis size. All inputs arrive
    replicated; restraint rows are laid out over the axis by shard_map.
    """
    L = x0.shape[0]
    n = mesh.shape[axis]
    if L % n:
        raise ValueError(f"L={L} must be a multiple of the {axis} axis size {n}")
    if bead_mask is None:
        bead_mask = jnp.ones((L,), dtype=jnp.float32)
    sched = build_schedule(cfg) if schedule is None else schedule
    base = _final_weights(cfg)

    def shard_step_fn(x, lo, hi, w, bead, srow):
        """Runs per shard: full-row energy/grad for owned rows, then a
        replicated update from the all-gathered gradient."""
        idx = jax.lax.axis_index(axis)
        Lb = lo.shape[0]
        row_start = idx * Lb
        lr, sigma, vdw_w, repel = srow
        weights = _schedule_weights(cfg, base, vdw_w, repel)
        e_noe, e_vdw, g_rows = row_block_energy_grad(
            x, lo, hi, w, bead, row_start, weights
        )
        e = jax.lax.psum(e_noe + e_vdw, axis)
        grad = jax.lax.all_gather(g_rows, axis, axis=0, tiled=True)  # (L, 3)
        # bonded terms (bond + optional angle): O(L), replicated per shard
        e_bond, gb = jax.value_and_grad(bonded_energy)(x, bead, weights)
        return e + e_bond, grad + gb

    mapped = jax.shard_map(
        shard_step_fn,
        mesh=mesh,
        in_specs=(P(), P(axis, None), P(axis, None), P(axis, None), P(), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )

    # alias-aware fold: for the two-tensor ExactRestraints form this is the
    # stored w (and lo/hi below are the SAME value, which XLA aliases to one
    # buffer) — the sharded solve then holds exactly 2 restraint tensors
    _, w_folded = exact_pair_tiles(restraints)

    key, jkey = jax.random.split(key)
    x = x0 + cfg.init_noise * jax.random.normal(jkey, x0.shape) * bead_mask[:, None]

    opt = optax.scale_by_adam()
    opt_state = opt.init(x)

    def step(carry, srow):
        x, opt_state, k = carry
        e, g = mapped(x, restraints.lo, restraints.hi, w_folded, bead_mask, srow)
        g = _clip_per_bead(g, cfg.gradient_clip)
        updates, opt_state = opt.update(g, opt_state)
        k, nkey = jax.random.split(k)
        lr, sigma = srow[0], srow[1]
        noise = sigma * jax.random.normal(nkey, x.shape)
        x = x + (-lr * updates + noise) * bead_mask[:, None]
        return (x, opt_state, k), e

    srows = jnp.stack(
        [sched.lr, sched.sigma, sched.vdw_weight, sched.repel_scale], axis=-1
    )
    (x, _, _), history = jax.lax.scan(step, (x, opt_state, key), srows)
    return x, history


class ShardedEnsembleResult(NamedTuple):
    coords: jnp.ndarray                 # (n_models, L, 3), centroid at origin
    energies: Dict[str, jnp.ndarray]    # each (n_models,), canonical weights
    history: jnp.ndarray                # (n_models, T) total energy per step


def solve_ensemble_sharded(
    mesh: Mesh,
    restraints: DenseRestraints,
    cfg: AnnealConfig,
    key: jax.Array,
    n_models: int,
    bead_mask: Optional[jnp.ndarray] = None,
    schedule: Optional[Schedule] = None,
    axis: str = "beads",
    or_groups=None,
) -> ShardedEnsembleResult:
    """The full ensemble solve with the O(L^2) work row-sharded over `axis`:
    landmark init from the sharded restraint rows, mirror-pair hot phase,
    CNS-style enantiomer pick (chromosome3D.pl:1605-1727), cool + final on
    the winners — no host-fed x0, no (L, L) tensor ever replicated.

    Matches solver.anneal.solve_ensemble_impl semantics with
    init="landmark" (tested equal on a CPU mesh). L must be a multiple of
    the axis size (pad with bead_mask; see pad_restraints_to_multiple).

    or_groups: optional ambiguous (`or`-group) restraints
    (ops.energy.OrGroupRestraints) — the group-min well joins the energy.
    Coordinates are replicated across the axis, so the O(R*G) group term
    computes REPLICATED on every shard like the bonded terms (no
    collectives; tiny next to the sharded O(L^2/n) pair work) — at-scale
    external CNS tbl files with ambiguous rows keep the sharded path
    (chromosome3D.pl:487-554 defines the layouts; CNS solves them at any
    size)."""
    L = restraints.lo.shape[0]
    n_dev = mesh.shape[axis]
    if L % n_dev:
        raise ValueError(f"L={L} must be a multiple of the {axis} axis size {n_dev}")
    if bead_mask is None:
        bead_mask = jnp.ones((L,), dtype=jnp.float32)
    sched = build_schedule(cfg) if schedule is None else schedule
    srows = jnp.stack(
        [sched.lr, sched.sigma, sched.vdw_weight, sched.repel_scale], axis=-1
    )
    shard_fn = _ensemble_shard_fn(
        cfg, n_models, L, n_dev, sched, axis, with_og=or_groups is not None
    )

    og_args = () if or_groups is None else (or_groups,)
    og_specs = () if or_groups is None else (P(),)   # replicated subtree
    mapped = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(
            P(axis, None), P(axis, None), P(axis, None), P(), P(), P(),
        ) + og_specs,
        out_specs=(P(), {"noe": P(), "bon": P(), "vdw": P(), "overall": P()}, P()),
        check_vma=False,
    )
    t_lo, w_folded = exact_pair_tiles(restraints)
    coords, terms, history = mapped(
        t_lo,
        restraints.hi,   # == t_lo for ExactRestraints: XLA aliases, no copy
        w_folded,
        bead_mask,
        key,
        srows,
        *og_args,
    )
    return ShardedEnsembleResult(coords=coords, energies=terms, history=history)


def _ensemble_shard_fn(cfg: AnnealConfig, n_models: int, L: int, n_dev: int,
                       sched: Schedule, axis: str, with_og: bool = False):
    """Build the per-device ensemble shard body shared by the 1-D sp solver
    (solve_ensemble_sharded) and the 2-D chrom x beads genome solver
    (solve_genome_sharded, which vmaps it over chromosomes — the collectives
    inside batch cleanly under vmap).

    with_og: the body takes a trailing replicated OrGroupRestraints arg and
    adds the group-min well — computed per shard on the replicated coords
    like the bonded terms (identical on every device, no collectives)."""
    base = _final_weights(cfg)
    n_eff = n_models * 2 if cfg.enantiomer else n_models
    hot = cfg.hot_steps
    k_land = min(cfg.landmark_count, L)
    # hot-loop route: the GPU pair kernel on each shard's row block, or the
    # plain analytic rows (the same choice solver.anneal makes); exact
    # restraints read the two-tensor (target, w) form
    use_kernel = resolve_use_pallas(cfg)
    exact = _exact(cfg)

    def shard_fn(lo, hi, w, bead, key, srows, og=None):
        """Everything below runs per device on its (Lb, L) restraint rows;
        coordinates, optimizer state, and RNG are replicated (identical on
        every device), so only psum/pmin/all_gather cross devices."""
        idx = jax.lax.axis_index(axis)
        Lb = lo.shape[0]
        row_start = idx * Lb

        # ---- landmark init from the sharded rows ----
        # two-sided: the upper relaxation paths through HI edges (the
        # bounds-matrix convention — see solver.init landmark_targets'
        # edge_rows use_hi note).
        # Tiles may arrive bf16-STORED (device_prep out_dtype="bfloat16");
        # the init math runs f32 like the single-device path's upcast — these
        # casts are init-transient, the hot loop reads the tiles natively
        target = (hi if cfg.embed_two_sided else 0.5 * (lo + hi)).astype(
            jnp.float32
        )
        rows_g = row_start + jax.lax.broadcasted_iota(jnp.int32, (Lb, L), 0)
        cols_g = jax.lax.broadcasted_iota(jnp.int32, (Lb, L), 1)
        bm_rows = jax.lax.dynamic_slice(bead, (row_start,), (Lb,))
        pair_real = (bm_rows[:, None] * bead[None, :]) > 0
        w_edges = jnp.where(w > 0, target, _BIG)
        adjacent = (jnp.abs(rows_g - cols_g) == 1) & pair_real
        w_edges = jnp.where(adjacent, jnp.minimum(w_edges, cfg.bond_length), w_edges)
        w_edges = jnp.where(rows_g == cols_g, 0.0, w_edges)
        n_real = bead.sum()
        lidx = landmark_indices(L, k_land, n_real)
        delta = chain_metric_rows(lidx, L, cfg.bond_length)

        def sweep(delta, _):
            cand = relax_landmarks_block(delta, w_edges, row_start)
            cand = jax.lax.pmin(cand, axis)
            return jnp.minimum(delta, cand), None

        delta, _ = jax.lax.scan(sweep, delta, None, length=cfg.landmark_iters)
        if cfg.embed_two_sided:
            # bounds-MATRIX semantics at scale (solver.init.landmark_targets
            # run on the sharded rows): raise landmark-row lower bounds by
            # the inverse-triangle sweep over this block's lo rows (pmax
            # across the axis), then clip restrained targets into their
            # smoothed window — identical to the single-device two-sided
            # landmark path (tested equal on the CPU mesh)
            mask_rows = (w > 0).astype(delta.dtype) * pair_real.astype(delta.dtype)
            lo_rows = jnp.where(mask_rows > 0, lo.astype(delta.dtype), 0.0)
            lrel = lidx - row_start
            own = (lrel >= 0) & (lrel < Lb)
            lsafe = jnp.clip(lrel, 0, Lb - 1)
            lo_land = jnp.where(
                own[:, None], jnp.take(lo_rows, lsafe, axis=0), -_BIG
            )
            mask_land = jnp.where(
                own[:, None], jnp.take(mask_rows, lsafe, axis=0), -_BIG
            )
            lo_land = jax.lax.pmax(lo_land, axis)
            mask_land = jax.lax.pmax(mask_land, axis)
            cand = jax.lax.pmax(
                relax_landmarks_lower_block(delta, lo_rows, row_start), axis
            )
            delta = clip_landmark_targets(
                delta, jnp.maximum(lo_land, cand), mask_land
            )
        x0 = landmark_triangulate(delta, lidx).astype(jnp.float32)
        x0 = x0 * bead[:, None]

        # ---- mirror pairs + per-restart jitter (replicated RNG) ----
        if cfg.enantiomer:
            signs = jnp.tile(jnp.asarray([1.0, -1.0], jnp.float32), n_models)
        else:
            signs = jnp.ones((n_eff,), jnp.float32)
        key_, jkey = jax.random.split(key)
        xs = x0[None, :, :] * jnp.stack(
            [signs, jnp.ones_like(signs), jnp.ones_like(signs)], axis=-1
        )[:, None, :]
        xs = xs + cfg.init_noise * jax.random.normal(jkey, xs.shape) * bead[None, :, None]

        def bond_energy(c):
            return bonded_energy(c, bead, base)

        bond_vg = jax.vmap(jax.value_and_grad(bond_energy))

        if with_og:
            # group-min well on the replicated coords — per shard, no
            # collectives (ops.energy.or_group_energy; O(R*G) gathers)
            from chromosome3d.ops.energy import or_group_energy

            def og_vg(x, weights):
                return jax.vmap(
                    jax.value_and_grad(
                        lambda c: or_group_energy(c, og, weights, bead)
                    )
                )(x)
        else:
            og_vg = None    # use sites guard on with_og (static)

        def pair_terms(x, weights):
            """(e_noe, e_vdw, grad) per structure, psum'd/gathered."""
            e_noe, e_vdw, g_rows = jax.vmap(
                lambda c: row_block_energy_grad(
                    c, lo, hi, w, bead, row_start, weights
                )
            )(x)
            e_noe = jax.lax.psum(e_noe, axis)
            e_vdw = jax.lax.psum(e_vdw, axis)
            g = jax.lax.all_gather(g_rows, axis, axis=1, tiled=True)  # (n, L, 3)
            return e_noe, e_vdw, g

        tiles = (lo, w) if exact else (lo, hi, w)
        if exact and cfg.pair_bf16:
            # AnnealConfig.pair_bf16: bf16 tiles, f32 math (no-op when the
            # tiles already arrive bf16-stored)
            tiles = tuple(t.astype(jnp.bfloat16) for t in tiles)

        def pair_total_and_grad(x, weights):
            """Hot-loop pair terms: total energy and gathered gradient."""
            e_p, g_rows = pair_energy_grad_batched(
                x, tiles, bead, weights, row_start, use_kernel
            )
            e = jax.lax.psum(e_p, axis)
            g = jax.lax.all_gather(g_rows, axis, axis=1, tiled=True)
            return e, g

        opt = optax.scale_by_adam()
        carry0 = (xs, opt.init(xs), key_)

        def step(carry, srow):
            x, opt_state, k = carry
            lr, sigma, vdw_w, repel = srow[0], srow[1], srow[2], srow[3]
            weights = _schedule_weights(cfg, base, vdw_w, repel)
            e_pair, g = pair_total_and_grad(x, weights)
            e_bond, g_bond = bond_vg(x)
            if with_og:
                e_og, g_og = og_vg(x, weights)
                e_pair = e_pair + e_og
                g = g + g_og
            e = e_pair + e_bond
            g = _clip_per_bead(g + g_bond, cfg.gradient_clip)
            updates, opt_state = opt.update(g, opt_state)
            k, nkey = jax.random.split(k)
            noise = sigma * jax.random.normal(nkey, x.shape)
            x = x + (-lr * updates + noise) * bead[None, :, None]
            return (x, opt_state, k), e

        def select(carry, sel):
            x, opt_state, k = carry
            opt_state = jax.tree.map(
                lambda a: a[sel]
                if (hasattr(a, "ndim") and a.ndim >= 1 and a.shape[0] == n_eff)
                else a,
                opt_state,
            )
            return (x[sel], opt_state, k)

        if cfg.enantiomer:
            carry, hist_hot = jax.lax.scan(step, carry0, srows[:hot])
            w_hot = _schedule_weights(
                cfg, base, sched.vdw_weight[hot - 1], sched.repel_scale[hot - 1]
            )
            e_bond, _ = bond_vg(carry[0])
            e_hot = pair_total_and_grad(carry[0], w_hot)[0] + e_bond
            if with_og:
                e_hot = e_hot + og_vg(carry[0], w_hot)[0]
            pick = jnp.argmin(e_hot.reshape(n_models, 2), axis=1)
            sel = jnp.arange(n_models) * 2 + pick
            carry = select(carry, sel)
            hist_hot = hist_hot[:, sel]
            carry, hist_rest = jax.lax.scan(step, carry, srows[hot:])
            history = jnp.concatenate([hist_hot, hist_rest], axis=0).T
        else:
            carry, history = jax.lax.scan(step, carry0, srows)
            history = history.T
        xs = carry[0]

        # ---- final canonical-weight terms + centroid to origin ----
        e_noe, e_vdw, _ = pair_terms(xs, base)
        if with_og:
            # the group well reports inside `noe` (ops.energy.energy_terms
            # convention)
            e_noe = e_noe + og_vg(xs, base)[0]
        e_bond, _ = bond_vg(xs)
        terms = {
            "noe": e_noe,
            "bon": e_bond,
            "vdw": e_vdw,
            "overall": e_noe + e_vdw + e_bond,
        }
        nvalid = jnp.maximum(bead.sum(), 1.0)
        centroid = (xs * bead[None, :, None]).sum(axis=1, keepdims=True) / nvalid
        xs = (xs - centroid) * bead[None, :, None]
        return xs, terms, history

    return shard_fn


def solve_genome_sharded(
    mesh: Mesh,
    batched: DenseRestraints,
    cfg: AnnealConfig,
    keys: jax.Array,
    n_models: int,
    bead_masks: Optional[jnp.ndarray] = None,
    schedule: Optional[Schedule] = None,
    chrom_axis: str = "chrom",
    beads_axis: str = "beads",
) -> ShardedEnsembleResult:
    """Many chromosomes, each beyond one device, in ONE program: the full
    sharded ensemble solve over a 2-D (chrom x beads) mesh. Chromosomes
    split over `chrom_axis` (data parallel, zero collectives between them);
    each chromosome's O(L^2) restraint rows split over `beads_axis` exactly
    as solve_ensemble_sharded does (the same shard body, vmapped over the
    device-local chromosomes — its psum/pmin/all_gather batch under vmap).

    This composes the genome runner's dp axis with the sp axis: the
    reference's whole-genome story is 46 independent processes
    (test.sh:4-11) capped at 663 beads each (chromosome3D.pl:93-94); here
    one mesh covers arbitrarily many chromosomes of one-device-exceeding
    length. batched: (B, L, L) tensors; keys: (B, 2) one PRNG key per
    chromosome; B must divide the chrom axis, L the beads axis.
    Returns batched results with a leading chromosome axis."""
    B, L = batched.lo.shape[0], batched.lo.shape[1]
    nc, nb = mesh.shape[chrom_axis], mesh.shape[beads_axis]
    if B % nc:
        raise ValueError(f"B={B} must be a multiple of the {chrom_axis} axis {nc}")
    if L % nb:
        raise ValueError(f"L={L} must be a multiple of the {beads_axis} axis {nb}")
    if bead_masks is None:
        bead_masks = jnp.ones((B, L), dtype=jnp.float32)
    sched = build_schedule(cfg) if schedule is None else schedule
    srows = jnp.stack(
        [sched.lr, sched.sigma, sched.vdw_weight, sched.repel_scale], axis=-1
    )
    shard_fn = _ensemble_shard_fn(cfg, n_models, L, nb, sched, beads_axis)
    vshard = jax.vmap(shard_fn, in_axes=(0, 0, 0, 0, 0, None))

    Pc, Pcb = P(chrom_axis), P(chrom_axis, beads_axis, None)
    mapped = jax.shard_map(
        vshard,
        mesh=mesh,
        in_specs=(Pcb, Pcb, Pcb, P(chrom_axis, None), P(chrom_axis, None), P()),
        out_specs=(Pc, {"noe": Pc, "bon": Pc, "vdw": Pc, "overall": Pc}, Pc),
        check_vma=False,
    )
    t_lo, w_folded = exact_pair_tiles(batched)
    coords, terms, history = mapped(
        t_lo,
        batched.hi,      # == t_lo for ExactRestraints: XLA aliases, no copy
        w_folded,
        bead_masks,
        keys,
        srows,
    )
    return ShardedEnsembleResult(coords=coords, energies=terms, history=history)


def pad_restraints_to_multiple(restraints, n_dev: int):
    """Host-side helper: pad a chromosome3d.restraints.Restraints to the
    next multiple of n_dev and return (padded Restraints, bead_mask ndarray).
    Use before dense_restraints_from_numpy for the sharded solvers."""
    L = restraints.length
    L_pad = -(-L // n_dev) * n_dev
    bead = np.zeros(L_pad, dtype=np.float32)
    bead[:L] = 1.0
    return restraints.padded(L_pad), bead
