"""The distance-geometry energy model, dense jnp reference implementation.

Re-design of the CNS energy engine as configured by the reference
(SURVEY.md N1/N5; chromosome3D.pl:1092-1135, 1395-1426):

  * NOE restraint term  — soft-square flat-bottom well on every restrained
    pair: viol = relu(d - hi) + relu(lo - d), E = w_noe * viol^2, where
    [lo, hi] = [target - negdev, target + posdev]. The reference's restraints
    are exact (negdev = posdev = 0, chromosome3D.pl:352-354), so the well is a
    pure harmonic on |d - target|. "cent" averaging (:1133) degenerates to the
    plain pair distance for single-atom (CA) groups.

  * chain bond term     — harmonic |x_{i+1} - x_i| ~ bond_length, replacing
    the protein topology (N1) that held consecutive CA beads near 3.8 A.

  * vdw repel term      — CNS REPEl soft sphere (:1395-1404): overlap
    penalty E = w_vdw * relu(repel_scale * radius - d)^2 on nonbonded pairs
    (|i - j| >= 2). The anneal schedule ramps w_vdw 0.003 -> 4.0 and
    repel_scale 1.0 -> 0.85 exactly as the slow-cool does (:1740-1782).

Everything is a function of pairwise distances only, so the energy is
rotation/translation/mirror invariant (tested property). The O(L^2) work is
dense masked elementwise math; padding beads are masked via `bead_mask`, which lets
one compiled program serve a whole length bucket (genome runs).

The hot loop's analytic energy+grad (ops/pair.py) and the fused GPU
kernel (ops/pair_kernel.py) have identical semantics; this file is the
semantic reference they are tested against.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


class DenseRestraints(NamedTuple):
    """Dense restraint tensors on device. lo/hi are the well bounds;
    mask is 1.0 where a restraint exists (symmetric, zero diagonal);
    weight is a per-restraint multiplier folded into the NOE term."""

    lo: jnp.ndarray      # (L, L) float32
    hi: jnp.ndarray      # (L, L) float32
    mask: jnp.ndarray    # (L, L) float32
    weight: jnp.ndarray  # (L, L) float32


class ExactRestraints(NamedTuple):
    """TWO-tensor restraint representation for the exact production path.

    The pipeline's own restraints are always exact (negdev = posdev = 0,
    chromosome3D.pl:352-354), so lo == hi == target and mask is recoverable
    as (weight > 0) — the dense four-tensor DenseRestraints form carries 2x
    redundant (L, L) data for them. At scale that redundancy IS the memory
    ceiling: at L = 16384 each extra live (L, L) f32 costs 1 GiB of HBM.

    This form ships exactly what the exact kernels read: the target matrix
    and the folded weight w = mask * weight (zero where no restraint or
    either bead is padding). The lo/hi/mask/weight properties make it a
    drop-in for every DenseRestraints consumer — aliases or cheap transient
    recomputations, never persistent copies. Only valid when the well is
    pure quadratic (auto_exact is the gate, same as the exact kernel)."""

    target: jnp.ndarray  # (L, L) float32 restraint target distances
    w: jnp.ndarray       # (L, L) float32 folded weights (mask * weight)

    @property
    def lo(self):
        return self.target

    @property
    def hi(self):
        return self.target

    @property
    def mask(self):
        # transient; exact under both weighting modes (weight > 0 iff mask)
        return (self.w > 0).astype(self.w.dtype)

    @property
    def weight(self):
        # consumers only ever read mask * weight == w; returning w keeps
        # that product exact while mask supplies the pure indicator
        return self.w


class OrGroupRestraints(NamedTuple):
    """Ambiguous (`or`-group) NOE restraints on device.

    CNS tbl files may restrain the MINIMUM distance over a set of alternative
    atom pairs (the 4 `or`-group layouts the reference's assessor tolerates,
    chromosome3D.pl:487-554). The reference only ever *assesses* such rows
    (its own generated tbl has none), but CNS itself solves them, so external
    tbl inputs are first-class solver inputs here.

    Each of the R group restraints carries up to G alternative (i, j) bead
    pairs (the flattened cross product of its two atom groups). The energy
    wells the minimum distance over the alternatives — identical semantics
    to ssnoe_tbl_min_pdb_dist's assessment metric, and the correct ambiguous
    generalization of the pair well (the gradient flows to the argmin pair,
    pulling the closest alternative toward the target).

    Shapes are padded static: (R, G) index/validity tensors, (R,) bounds.
    This is O(R*G) gather work — tiny next to the O(L^2) dense term — and
    stays in jnp (XLA fuses it around the pair call)."""

    idx_i: jnp.ndarray    # (R, G) int32 bead index of each alternative
    idx_j: jnp.ndarray    # (R, G) int32
    member: jnp.ndarray   # (R, G) float32, 1.0 for real alternatives
    lo: jnp.ndarray       # (R,) float32 lower well bound
    hi: jnp.ndarray       # (R,) float32 upper well bound
    weight: jnp.ndarray   # (R,) float32 per-restraint weight (0 = padding row)


def or_group_energy(
    coords: jnp.ndarray,
    og: OrGroupRestraints,
    weights: "EnergyWeights",
    bead_mask: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """NOE energy of the or-group restraints for one structure.

    Same soft-square well as the dense pair term, applied to the minimum
    distance over each restraint's alternatives. Counted ONCE per restraint
    (the dense term's 1/2 compensates its symmetric double storage; groups
    are stored once). Invalid alternatives are pushed to +inf so they never
    win the min; an all-invalid row contributes 0 via its zero weight."""
    xi = coords[og.idx_i]                          # (R, G, 3)
    xj = coords[og.idx_j]
    diff = xi - xj
    d = jnp.sqrt((diff * diff).sum(-1) + _EPS)     # (R, G)
    valid = og.member
    if bead_mask is not None:
        valid = valid * bead_mask[og.idx_i] * bead_mask[og.idx_j]
    dmin = jnp.min(jnp.where(valid > 0.0, d, jnp.inf), axis=1)
    dmin = jnp.where(jnp.isfinite(dmin), dmin, 0.0)
    row_ok = (valid.max(axis=1) > 0.0).astype(coords.dtype)
    viol = jnp.maximum(dmin - og.hi, 0.0) + jnp.maximum(og.lo - dmin, 0.0)
    s = weights.noe_rswitch
    well = jnp.where(viol <= s, viol * viol, s * s + 2.0 * s * (viol - s))
    return weights.noe * (og.weight * row_ok * well).sum()


class EnergyWeights(NamedTuple):
    """Per-step energy weights (the anneal schedule mutates these)."""

    noe: jnp.ndarray         # scalar
    bond: jnp.ndarray        # scalar
    bond_length: jnp.ndarray # scalar
    vdw: jnp.ndarray         # scalar
    vdw_radius: jnp.ndarray  # scalar: repel_scale * bead radius (effective)
    # soft-square switch (CNS NOE potential asymptote): violations beyond
    # rswitch grow linearly (slope 2*rswitch, C1-continuous) instead of
    # quadratically, so the unsatisfiable far restraints produced by tiny IF
    # values (targets of hundreds of A) exert bounded force. Set to a large
    # value for a pure harmonic well.
    noe_rswitch: jnp.ndarray = jnp.float32(1e9)
    # chain-stiffness (angle) weight: E = angle * sum(1 - cos phi) over
    # consecutive bond-vector pairs (AnnealConfig.angle_weight; 0 = off,
    # the validated default)
    angle: jnp.ndarray = jnp.float32(0.0)


def auto_weight_exponent(L: int) -> float:
    """Length-adaptive stress exponent p*(L) = clip(100 / L^0.85, 0.5, 2.5).

    Fit to per-chromosome sweeps of best Spearman(IF, 1/d) vs p on the
    shipped inputs (both resolutions): small chromosomes want steep weights
    (local detail dominates the pair count), large chromosomes want flat
    weights (global shape dominates). Observed optima: L=35..73 -> ~2.5,
    L=96..120 -> ~1.5, L=192 -> ~1.0, L=455 -> ~0.5."""
    return float(np.clip(100.0 / (L ** 0.85), 0.5, 2.5))


def _restraint_weights(target, mask_np, weighting: str, weight_exponent):
    """Per-restraint weights as float32 host numpy (see
    dense_restraints_from_numpy's docstring for the weighting semantics).
    Zero wherever mask is false — i.e. already folded with the mask."""
    if weight_exponent is None:
        weight_exponent = auto_weight_exponent(target.shape[0])
    if weighting == "relative":
        w = np.where(mask_np, 1.0 / np.maximum(target, 1.0) ** weight_exponent, 0.0)
        denom = w[mask_np].mean() if mask_np.any() else 1.0
        return (w / max(denom, 1e-30)).astype(np.float32)
    elif weighting == "absolute":
        return mask_np.astype(np.float32)
    raise ValueError(f"unknown weighting {weighting!r}")


def exact_restraints_from_numpy(
    r, weighting: str = "relative", weight_exponent: Optional[float] = None,
    as_numpy: bool = False,
) -> ExactRestraints:
    """chromosome3d.restraints.Restraints -> the TWO-tensor exact form.

    Same weighting semantics as dense_restraints_from_numpy (shared
    implementation), but only target + folded weight are built and uploaded
    — half the host->device transfer and half the live restraint memory
    of the four-tensor form. The
    caller must have proven exactness (pipeline.auto_exact: all deviations
    zero AND the pure-quadratic well active)."""
    target = np.asarray(r.target, dtype=np.float64)
    mask_np = np.asarray(r.mask)
    weight = _restraint_weights(target, mask_np, weighting, weight_exponent)
    out = ExactRestraints(
        target=np.where(mask_np, target, 0.0).astype(np.float32),
        w=weight,
    )
    if as_numpy:
        return out
    return ExactRestraints(*(jnp.asarray(t) for t in out))


def dense_restraints_from_numpy(
    r, weighting: str = "relative", weight_exponent: Optional[float] = None,
    as_numpy: bool = False,
) -> DenseRestraints:
    """chromosome3d.restraints.Restraints -> device tensors
    (or host numpy tensors with as_numpy=True, for batch assemblers).

    weighting:
      "relative" — per-restraint weight 1/target^p (p = weight_exponent,
        default 2), normalized to mean 1 over the restraint set. This is
        stress-majorization weighting: a given *fractional* violation costs
        the same at any target distance, which makes the solver preserve the
        IF matrix's rank ordering (the Spearman objective). Absolute
        weighting lets the enormous low-IF targets (hundreds to thousands of
        A, SURVEY.md section 2.3) blow the structure apart; measured on
        chr21/chr13/chr20 it loses ~0.1 Spearman. p = 2.0 was the max of a
        p-grid sweep across chromosomes at both resolutions.
        The mean-1 normalization keeps the NOE scale comparable to the
        bond/vdw terms and keeps weights out of the subnormal range (which
        costs >50x on some hosts).
      "absolute" — weight 1 (the raw CNS NOE convention).
    """
    target = np.asarray(r.target, dtype=np.float64)
    mask_np = np.asarray(r.mask)
    mask = mask_np.astype(np.float32)
    weight = _restraint_weights(target, mask_np, weighting, weight_exponent)
    out = DenseRestraints(
        lo=(target - np.asarray(r.negdev)).astype(np.float32),
        hi=(target + np.asarray(r.posdev)).astype(np.float32),
        mask=mask,
        weight=weight,
    )
    if as_numpy:
        # host tensors: batch assemblers stack many chromosomes host-side
        # and pay ONE device upload per tensor, not one per chromosome
        return out
    return DenseRestraints(*(jnp.asarray(t) for t in out))


def dense_or_groups_from_numpy(og) -> OrGroupRestraints:
    """restraints.OrGroups (host numpy) -> device OrGroupRestraints."""
    return OrGroupRestraints(
        idx_i=jnp.asarray(og.idx_i, jnp.int32),
        idx_j=jnp.asarray(og.idx_j, jnp.int32),
        member=jnp.asarray(og.member, jnp.float32),
        lo=jnp.asarray(og.lo, jnp.float32),
        hi=jnp.asarray(og.hi, jnp.float32),
        weight=jnp.asarray(og.weight, jnp.float32),
    )


_EPS = 1e-12


def _angle_energy(bond_vec, bond_d, bond_valid, weights) -> jnp.ndarray:
    """Worm-like-chain bending term: angle * sum(1 - cos phi_i) over
    consecutive bond-vector pairs (phi = 0 when the chain is straight).
    The reduced analogue of CNS's `angl` flag on the fake protein
    (chromosome3D.pl:1640-1642, 1866-1886); zero-cost no-op at angle=0."""
    cosphi = (bond_vec[:-1] * bond_vec[1:]).sum(-1) / (bond_d[:-1] * bond_d[1:])
    tri_valid = bond_valid[:-1] * bond_valid[1:]
    return weights.angle * (tri_valid * (1.0 - cosphi)).sum()


def _pair_distances(coords: jnp.ndarray) -> jnp.ndarray:
    """(L, 3) -> (L, L) distances, grad-safe at d ~ 0 off-diagonal.

    Computed by direct differencing (3 * L^2 flops). A Gram-matrix
    formulation (X @ X.T) would be a matrix product with K = 3, far too
    narrow for a matrix unit, and differencing is numerically better.
    """
    diff = coords[:, None, :] - coords[None, :, :]
    d2 = (diff * diff).sum(-1)
    return jnp.sqrt(d2 + _EPS)


def energy_terms(
    coords: jnp.ndarray,
    restraints: DenseRestraints,
    weights: EnergyWeights,
    bead_mask: jnp.ndarray | None = None,
    or_groups: OrGroupRestraints | None = None,
) -> Dict[str, jnp.ndarray]:
    """All energy terms for one structure. coords: (L, 3) float32.

    bead_mask: (L,) float32, 1.0 for real beads, 0.0 for padding. None means
    all beads are real.
    or_groups: optional ambiguous restraints; their well joins the noe term.
    """
    L = coords.shape[0]
    if bead_mask is None:
        bead_mask = jnp.ones((L,), dtype=coords.dtype)
    pair_valid = bead_mask[:, None] * bead_mask[None, :]

    d = _pair_distances(coords)

    # --- NOE restraints (each unordered pair counted once: mask is
    #     symmetric, so sum over the full matrix and halve) ---
    viol = jnp.maximum(d - restraints.hi, 0.0) + jnp.maximum(restraints.lo - d, 0.0)
    noe_mask = restraints.mask * pair_valid
    s = weights.noe_rswitch
    well = jnp.where(viol <= s, viol * viol, s * s + 2.0 * s * (viol - s))
    e_noe = 0.5 * weights.noe * (noe_mask * restraints.weight * well).sum()
    if or_groups is not None:
        e_noe = e_noe + or_group_energy(coords, or_groups, weights, bead_mask)

    # --- chain bonds (+ optional angle stiffness, reported inside `bon`
    #     like CNS's bonded internal terms) ---
    bond_vec = coords[1:] - coords[:-1]
    bond_d = jnp.sqrt((bond_vec * bond_vec).sum(-1) + _EPS)
    bond_valid = bead_mask[1:] * bead_mask[:-1]
    bdev = bond_d - weights.bond_length
    e_bond = weights.bond * (bond_valid * bdev * bdev).sum()
    e_bond = e_bond + _angle_energy(bond_vec, bond_d, bond_valid, weights)

    # --- vdw soft-sphere repel on nonbonded pairs (|i-j| >= 2) ---
    idx = jnp.arange(L)
    nonbonded = (jnp.abs(idx[:, None] - idx[None, :]) >= 2).astype(coords.dtype)
    overlap = jnp.maximum(weights.vdw_radius - d, 0.0)
    e_vdw = 0.5 * weights.vdw * (nonbonded * pair_valid * overlap * overlap).sum()

    total = e_noe + e_bond + e_vdw
    return {"noe": e_noe, "bon": e_bond, "vdw": e_vdw, "overall": total}


def _pick_row_chunk(L: int, cap: int = 512) -> int:
    """Largest divisor of L that is <= cap (L itself for pathological
    primes — the computation still proceeds, just without the bound)."""
    if L <= cap:
        return L
    for c in range(cap, 0, -1):
        if L % c == 0:
            return c
    return L


def energy_terms_chunked(
    coords: jnp.ndarray,
    restraints: DenseRestraints,
    weights: EnergyWeights,
    bead_mask: jnp.ndarray | None = None,
    or_groups: OrGroupRestraints | None = None,
    row_chunk: int = 512,
) -> Dict[str, jnp.ndarray]:
    """energy_terms with O(row_chunk * L) temporaries: the pair terms scan
    row blocks instead of materializing any (L, L) intermediate.

    The dense reference path's FINAL canonical-terms pass — not the hot
    loop — sets the single-device memory ceiling: at L = 24576 its vmapped
    soft-square well is a ~9 GB (n, L, L) temporary while the solve's own
    working set is far smaller. solve_ensemble
    switches to this evaluation beyond reference scale; at reference scale
    the dense path stays (identical float-summation order there keeps the
    NOE-ranking byte artifacts frozen). Values agree with energy_terms to
    float-reassociation tolerance (tests/test_energy.py pins it)."""
    L = coords.shape[0]
    if bead_mask is None:
        bead_mask = jnp.ones((L,), dtype=coords.dtype)
    Lb = _pick_row_chunk(L, row_chunk)
    s = weights.noe_rswitch
    # the two-tensor exact form stores mask * weight pre-folded; slicing its
    # .mask property would materialize the full (w > 0) transient
    exact_form = isinstance(restraints, ExactRestraints)

    def block(carry, r0):
        e_noe, e_vdw = carry
        a = jax.lax.dynamic_slice(coords, (r0, 0), (Lb, 3))
        bm_rows = jax.lax.dynamic_slice(bead_mask, (r0,), (Lb,))
        lo_b = jax.lax.dynamic_slice(restraints.lo, (r0, 0), (Lb, L))
        hi_b = lo_b if exact_form else jax.lax.dynamic_slice(
            restraints.hi, (r0, 0), (Lb, L)
        )
        if exact_form:
            wm_b = jax.lax.dynamic_slice(restraints.w, (r0, 0), (Lb, L))
        else:
            wm_b = jax.lax.dynamic_slice(
                restraints.mask, (r0, 0), (Lb, L)
            ) * jax.lax.dynamic_slice(restraints.weight, (r0, 0), (Lb, L))

        # coordinate-wise squared-distance accumulation: no (Lb, L, 3) temp
        d2 = jnp.full((Lb, L), _EPS, coords.dtype)
        for ax3 in range(3):
            dc = a[:, ax3][:, None] - coords[:, ax3][None, :]
            d2 = d2 + dc * dc
        d = jnp.sqrt(d2)
        pair_valid = bm_rows[:, None] * bead_mask[None, :]

        viol = jnp.maximum(d - hi_b, 0.0) + jnp.maximum(lo_b - d, 0.0)
        well = jnp.where(viol <= s, viol * viol, s * s + 2.0 * s * (viol - s))
        e_noe = e_noe + 0.5 * weights.noe * (wm_b * pair_valid * well).sum()

        rows = r0 + jax.lax.broadcasted_iota(jnp.int32, (Lb, L), 0)
        cols = jax.lax.broadcasted_iota(jnp.int32, (Lb, L), 1)
        nonbonded = (jnp.abs(rows - cols) >= 2).astype(coords.dtype)
        overlap = jnp.maximum(weights.vdw_radius - d, 0.0)
        e_vdw = e_vdw + 0.5 * weights.vdw * (
            nonbonded * pair_valid * overlap * overlap
        ).sum()
        return (e_noe, e_vdw), None

    zero = jnp.zeros((), coords.dtype)
    r0s = jnp.arange(L // Lb, dtype=jnp.int32) * Lb
    (e_noe, e_vdw), _ = jax.lax.scan(block, (zero, zero), r0s)
    if or_groups is not None:
        e_noe = e_noe + or_group_energy(coords, or_groups, weights, bead_mask)

    bond_vec = coords[1:] - coords[:-1]
    bond_d = jnp.sqrt((bond_vec * bond_vec).sum(-1) + _EPS)
    bond_valid = bead_mask[1:] * bead_mask[:-1]
    bdev = bond_d - weights.bond_length
    e_bond = weights.bond * (bond_valid * bdev * bdev).sum()
    e_bond = e_bond + _angle_energy(bond_vec, bond_d, bond_valid, weights)

    total = e_noe + e_bond + e_vdw
    return {"noe": e_noe, "bon": e_bond, "vdw": e_vdw, "overall": total}


def energy(
    coords: jnp.ndarray,
    restraints: DenseRestraints,
    weights: EnergyWeights,
    bead_mask: jnp.ndarray | None = None,
    or_groups: OrGroupRestraints | None = None,
) -> jnp.ndarray:
    return energy_terms(coords, restraints, weights, bead_mask, or_groups)["overall"]


energy_value_and_grad = jax.value_and_grad(energy)


def violation_stats(
    coords: jnp.ndarray,
    restraints: DenseRestraints,
    dist_relax: float = 0.5,
    sum_dev_margin: float = 0.2,
    bead_mask: jnp.ndarray | None = None,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Assessment statistics matching the reference exactly:

    satisfied — count_satisfied_tbl_rows (chromosome3D.pl:447-485): a
      restraint counts +1 if d < hi + relax, and then -1 again if
      d < lo - relax (i.e. too-short restraints cancel their own credit).
    total     — number of restraints.
    sum_dev   — sum_noe_dev (:581-600): sum of |deviation| outside
      [lo - margin, hi + margin].
    """
    L = coords.shape[0]
    if bead_mask is None:
        bead_mask = jnp.ones((L,), dtype=coords.dtype)
    pair_valid = bead_mask[:, None] * bead_mask[None, :]
    m = restraints.mask * pair_valid
    # count each unordered restraint once
    ut = jnp.triu(jnp.ones((L, L), dtype=coords.dtype), k=1)
    m = m * ut

    d = _pair_distances(coords)
    under_hi = (d < restraints.hi + dist_relax).astype(coords.dtype)
    under_lo = (d < restraints.lo - dist_relax).astype(coords.dtype)
    satisfied = (m * (under_hi - under_lo)).sum()
    total = m.sum()

    over = jnp.maximum(d - (restraints.hi + sum_dev_margin), 0.0)
    over_dev = jnp.where(over > 0, d - restraints.hi, 0.0)
    under = jnp.maximum((restraints.lo - sum_dev_margin) - d, 0.0)
    under_dev = jnp.where(under > 0, restraints.lo - d, 0.0)
    sum_dev = (m * (over_dev + under_dev)).sum()
    return satisfied, total, sum_dev


def weights_from_config(cfg, vdw_weight: float | jnp.ndarray | None = None,
                        repel_scale: float | jnp.ndarray = 1.0) -> EnergyWeights:
    """Build EnergyWeights from an AnnealConfig with optional schedule overrides."""
    vdw = cfg.vdw_weight_final if vdw_weight is None else vdw_weight
    return EnergyWeights(
        noe=jnp.float32(cfg.noe_weight),
        bond=jnp.float32(cfg.bond_weight),
        bond_length=jnp.float32(cfg.bond_length),
        vdw=jnp.asarray(vdw, dtype=jnp.float32),
        vdw_radius=jnp.asarray(repel_scale, dtype=jnp.float32) * cfg.vdw_radius,
        noe_rswitch=jnp.float32(cfg.noe_rswitch),
        angle=jnp.float32(cfg.angle_weight),
    )
